"""L1 trajectories of chip_smoke.py's phase-4 training run under variants of
its starting state, on one NVIDIA GPU.

Run from the repository root:  python3 tools/phase4_l1.py [--steps 20]

Phase 4 trains the full-width scene for main-stage steps at t = 0.5
towards the scene's own render, from a copy whose colours and opacities
are perturbed.  This script runs that training from fresh copies of the
scene and prints each step's L1 for each variant:
  cold           as phase 4 did: zero Adam moments, perturbed copy;
  cold clean     zero moments, unperturbed copy (the optimiser's floor);
  cold frozen    zero moments, perturbed copy, the deform MLP and the
                 nodes at LR 0 (is Adam's first step on them the rise?);
  warm           Adam's moments from WARM steps on the unperturbed scene,
                 then the parameters restored and perturbed, as phase 4
                 now starts;
  warm clean     the same without the perturbation.
Each variant's L1 list is one JSON line; the last line names the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke                                    # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase4_l1: needs a CUDA device", file=sys.stderr)
        return 1
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import (gauss_trainable, main_stage_step,
                                           mlp_trainable, node_trainable)

    dev = torch.device("cuda")
    cfg = RasterConfig()
    gauss, nodes, deform_cfg = smoke.full_scene(dev)
    cam = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=0.5,
                       device=dev)
    tcfg = TrainConfig(gaussian_capacity=gauss.capacity)
    gt = smoke.scene_render(gauss, nodes, deform_cfg, cam, cfg)
    params = lambda: {**{("g", k): v for k, v in
                         gauss_trainable(gauss).items()},
                      **{("m", k): v for k, v in
                         mlp_trainable(nodes).items()},
                      **{("n", k): v for k, v in
                         node_trainable(nodes).items()}}
    clean = {k: v.detach().clone() for k, v in params().items()}

    def restore():
        with torch.no_grad():
            for k, v in params().items():
                v.copy_(clean[k])

    def run(warm: bool, perturb: bool, frozen: bool) -> list:
        restore()
        scheds = smoke.phase4_schedules(tcfg, 2 * args.steps)
        run_cfg = tcfg
        if frozen:
            run_cfg = dataclasses.replace(tcfg, deform_lr_scale=0.0)
            scheds = [dict(s, deform_lr=0.0) for s in scheds]
        state = smoke.training_state(gauss, nodes, seed=5)
        if warm:
            state = smoke.warm_moments(state, cam, gt, run_cfg,
                                       scheds[:smoke.WARM_STEPS])
        scheds = scheds[smoke.WARM_STEPS:][:args.steps]
        if perturb:
            smoke.perturb(gauss, seed=6)
        l1s = []
        for sched in scheds:
            state, metrics = main_stage_step(state, cam, gt, run_cfg, sched)
            l1s.append(float(metrics["loss"]))
        return l1s

    variants = (("cold", False, True, False),
                ("cold clean", False, False, False),
                ("cold frozen", False, True, True),
                ("warm", True, True, False),
                ("warm clean", True, False, False))
    for rep in range(args.repeats):
        for name, warm, perturb, frozen in variants:
            l1s = run(warm, perturb, frozen)
            print(json.dumps({"variant": name, "repeat": rep,
                              "l1": l1s}), flush=True)
    print(smoke.gpu_name_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
