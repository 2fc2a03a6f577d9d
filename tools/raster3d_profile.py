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
Then it traces one ``main_stage_step`` (phase 4's schedule at 800x800,
every loss term on) without and with the optical-flow term (its sample:
the flow view's own render as the target flow, toward the next time of
the same camera), three steps of each after warm-up ones, and prints for
each the wall and device time per step, the idle share, the operators
with the most device time, K5's and K6's share of the device time (the
kernels of csrc/raster3d.cu, named r3d_*), and the operators whose device
time the flow term adds, largest first: the breakdown of what a flow step
costs over a plain one.
Needs an NVIDIA GPU; run from the repository root:

    python3 tools/raster3d_profile.py
"""
from __future__ import annotations

import json
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


def device_ms(event) -> float:
    """An operator's own device time in ms (its name in this PyTorch:
    self_device_time_total, self_cuda_time_total before 2.4)."""
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def trace_step(step, reps: int = 3, warm: int = 2) -> dict:
    """``step()`` traced ``reps`` times after ``warm`` untraced calls: wall
    and device ms per step, idle share, each operator's own device ms per
    step, and K5's and K6's device ms per step (kernels named r3d_*)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    r3d = sum(e.time_range.elapsed_us() for e in kernels
              if "r3d_" in e.name) / 1e3 / reps
    ops = {}
    for e in prof.key_averages():
        ms = device_ms(e) / reps
        if ms > 0 and e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0.0) + ms
    return {"wall_ms": wall, "device_ms": dev, "idle_share": 1 - dev / wall,
            "k5_k6_ms": r3d, "k5_k6_share": r3d / dev if dev else 0.0,
            "ops": ops}


def flow_step_breakdown(cs, dev) -> None:
    """main_stage_step without and with the flow term, traced in turns
    (plain, flow, flow, plain); prints each trace and the operators whose
    device time the flow term adds."""
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import main_stage_step
    gauss, nodes, deform_cfg = cs.full_scene(dev)
    tcfg = TrainConfig(gaussian_capacity=gauss.capacity)
    cams = [orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=t,
                         device=dev) for t in (0.5, 0.75)]
    gt = cs.scene_render(gauss, nodes, deform_cfg, cams[0], tcfg.raster)
    with torch.no_grad():
        flow = cs.scene_flow(gauss, nodes, deform_cfg, cams[0], cams[1],
                             tcfg.raster, cs.CLI_START)["render"][..., :2]
    cs.perturb(gauss, seed=6)
    state = cs.training_state(gauss, nodes, seed=5)
    sched = dict(cs.phase4_schedules(tcfg, 1)[0], lambda_optical=0.1)
    sample = (cams[1], flow, torch.ones_like(flow[..., :1]), 1.0)
    traces = {}
    for flow_loss in (False, True, True, False):
        r = trace_step(lambda: main_stage_step(
            state, cams[0], gt, tcfg, sched, flow_sample=sample,
            flow_loss=flow_loss))
        traces.setdefault(flow_loss, []).append(r)
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:10]
        print(f"main_stage_step {'with' if flow_loss else 'without'} the "
              f"flow term: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms, idle share {r['idle_share']:.3f}; "
              f"K5+K6 {r['k5_k6_ms']:.3f} ms ({r['k5_k6_share']:.4f} of the "
              f"device time); top operators (own device ms) "
              + json.dumps([(k, round(v, 3)) for k, v in top]), flush=True)
    mean = {f: {k: sum(r["ops"].get(k, 0.0) for r in rs) / len(rs)
                for k in set().union(*(r["ops"] for r in rs))}
            for f, rs in traces.items()}
    avg = lambda f, key: sum(r[key] for r in traces[f]) / len(traces[f])
    added = {k: mean[True].get(k, 0.0) - mean[False].get(k, 0.0)
             for k in mean[True]}
    top = sorted(added.items(), key=lambda kv: -kv[1])[:15]
    more = {k: avg(True, k) - avg(False, k) for k in ("wall_ms",
                                                       "device_ms")}
    print(f"the flow term adds {more['wall_ms']:.2f} ms of wall time and "
          f"{more['device_ms']:.2f} ms of device time a step (K5+K6 "
          f"{avg(True, 'k5_k6_ms'):.3f}); "
          f"operators by the device ms the flow term adds "
          + json.dumps([(k, round(v, 3)) for k, v in top]), flush=True)


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
    del gauss, nodes, xs, inputs
    torch.cuda.empty_cache()
    flow_step_breakdown(cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
