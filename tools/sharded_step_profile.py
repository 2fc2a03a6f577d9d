"""Profile the sharded main-stage step against main_stage_step on one card.

Run from the repository root on an NVIDIA GPU:

    python3 tools/sharded_step_profile.py

On chip_smoke.py's phase-3 scene (83,252 Gaussians, 800x800, t = 0.5,
every loss term on), through NCCL at world size 1 (a 1 x 1 rank grid: the
sharded path's records, exchange, merge and slab blend, with one rank),
it times each step between two synchronisations after warm-up steps, then
traces three steps of each under torch.profiler and prints, for each, the
wall time, the device time, the device's idle share over the steps and
the operators with the most device time and the most host time.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
WARM, TIMED, TRACED = 3, 5, 3


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist
    import torch.profiler as tp

    import chip_smoke as cs
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models import regularizers as R
    from d2dgs_torch.parallel import (make_mesh2d, shard_gauss_state,
                                      sharded_train_step,
                                      suggest_exchange_cap)
    from d2dgs_torch.parallel.multihost import maybe_init_distributed
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import main_stage_step
    from d2dgs_torch.utils.quaternion import quat_normalize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="sharded_profile_")
    maybe_init_distributed("cuda", init_method=f"file://{tmp}/store",
                           world_size=1, rank=0)
    mesh = make_mesh2d(1, 1)
    cfg = RasterConfig()
    gauss, nodes, deform_cfg = cs.full_scene(dev)
    cam = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=0.5,
                       device=dev)
    gt = cs.scene_render(gauss, nodes, deform_cfg, cam, cfg)
    cs.perturb(gauss, seed=6)
    tcfg = TrainConfig(gaussian_capacity=gauss.capacity)
    state = cs.training_state(gauss, nodes, seed=5)
    g = state.gauss
    with torch.no_grad():
        cap = suggest_exchange_cap(mesh.gauss_group, [cam], g.xyz,
                                   g.get_scaling,
                                   quat_normalize(g.rotation, eps=1e-12),
                                   g.alive, tcfg.raster, margin=2.0)
    sched = cs.phase4_schedules(tcfg, 1)[0]
    gen = torch.Generator().manual_seed(12)
    draws = R.arap_draws(gen, nodes.nodes.shape[0])
    sharded = shard_gauss_state(mesh, cs.clone_state(state))
    steps = {
        "sharded": lambda: sharded_train_step(
            sharded, [cam], gt[None], sched, tcfg, mesh, cap,
            arap_draws=draws),
        "main_stage_step": lambda: main_stage_step(
            state, cam, gt, tcfg, sched, arap_draws=draws)}
    print(f"card: {card}; exchange cap {cap} records", flush=True)
    for name, fn in steps.items():
        for _ in range(WARM):
            fn()
        ms = [cs.synced_ms(fn)[1] for _ in range(TIMED)]
        with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                    tp.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(TRACED):
                fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        device_us = sum(e.self_device_time_total for e in ev)
        span = [e for e in prof.events() if e.device_type.name == "CUDA"]
        t0 = min(e.time_range.start for e in span)
        t1 = max(e.time_range.end for e in span)
        idle = 1.0 - device_us / max(t1 - t0, 1)
        print(f"[{name}] step ms (between synchronisations) "
              + ", ".join(f"{v:.2f}" for v in ms)
              + f"; median {np.median(ms):.2f}; traced {TRACED} steps: "
              f"device {device_us / 1e3 / TRACED:.2f} ms a step, idle "
              f"share {idle:.3f} of the span, "
              f"{sum(e.count for e in ev if e.device_type.name == 'CUDA')}"
              f" device events ({card})", flush=True)
        print(ev.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=48), flush=True)
        print(ev.table(sort_by="self_cpu_time_total", row_limit=12,
                       max_name_column_width=48), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
