"""Where the 3DGS flow rasterizer's time goes on the card.

Runs ``d2dgs_torch.ops.raster3d.rasterize_3dgs`` on the flow inputs of
``chip_smoke.py`` phase 8 (the phase-3 scene: 83,252 Gaussians, 800x800,
the flow between two times of one orbit camera) under ``torch.profiler``,
forward alone and forward plus backward, on each route of its tile blend
(the kernels K5/K6 of csrc/raster3d.cu, then the plain walk
``blend3d_plain``, then the kernels again), and prints for each: the
wall time between two device synchronisations, the summed device time of
the CUDA kernels it launched, the kernel count, the device's idle share
(1 - device time / wall time) and the kernels with the most device time.
Needs an NVIDIA GPU; run from the repository root:

    python3 tools/raster3d_profile.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def profile(fn, reps: int = 3) -> dict:
    """Wall ms per call (device synchronised around the calls), summed
    device ms of the CUDA kernels per call, kernels per call, idle share
    and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_ms": dev_ms,
            "kernels": len(kernels) // reps,
            "idle_share": 1.0 - dev_ms / wall,
            "top": [(name[:60], round(ms, 3)) for name, ms in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("raster3d_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.synthetic import video_cameras
    dev = torch.device("cuda")
    print(cs.gpu_name_power(), torch.__version__, flush=True)
    gauss, nodes, deform_cfg = cs.full_scene(dev)
    cams = video_cameras(8, 4, 800, 800, device=dev)
    cam1 = cams[1]
    inputs = cs.flow_raster_inputs(gauss, nodes, deform_cfg, cam1, cams[2],
                                   cs.CLI_START)
    cfg = RasterConfig()
    xs = [a.clone().requires_grad_(True) for a in inputs]
    w = torch.rand((cam1.H, cam1.W, 5), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))

    def fwd(plain):
        with torch.no_grad():
            cs.flow_raster_route(plain, inputs, cam1, cfg)

    def fwd_bwd(plain):
        out = cs.flow_raster_route(plain, xs, cam1, cfg)
        torch.autograd.grad(torch.sum(torch.cat(out, -1) * w), xs)

    for route, plain in (("kernels", False), ("plain", True),
                         ("kernels", False)):
        for name, fn in (("forward", fwd), ("forward + backward", fwd_bwd)):
            r = profile(lambda: fn(plain))
            print(f"{route}, {name}: wall {r['wall_ms']:.2f} ms, device "
                  f"{r['device_ms']:.2f} ms in {r['kernels']} kernels, idle "
                  f"share {r['idle_share']:.3f}; top {r['top']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
