"""Adam's kernel (csrc/adam.cu) on a training step's three parameter
groups, on one NVIDIA GPU: whether a step through it is bitwise a step of
the plain PyTorch version, its launches, and its time beside its bound,
the plain version and torch.optim.Adam's fused step.

Run from the repository root:  python3 tools/adam_time.py
(chip_smoke.py imports ``measure`` for its ``kernels`` line.)

The groups are a TrainState's (``init_train_state`` at the default
TrainConfig, capacity 200,000) with the node field (node-train's), the
hash field (hash-train's) and the 8x256 MLP field (mlp-train's), every
leaf with a gradient, the Gaussians at their per-name learning rates.
``groups_of`` and ``clone`` also give tests/test_torch_adam.py its
groups.  ``ms`` and ``plain_ms`` are the device
time of one step of the three groups (``adam_update`` or
``adam_update_plain``, the count's advance included), the mean of
``--reps`` steps between two CUDA events after a warm-up; ``host_ms`` and
``plain_host_ms`` the host's time to issue that step, from a synchronised
start.  The bound is the bytes the update must move (p, g, m and v read,
p, m and v written: 28 a float32 element) over 3.35 TB/s, the H100 SXM's
HBM.  ``library_ms`` is torch.optim.Adam(fused=True) on copies of the
same leaves, one learning rate a group (its eps goes inside the square
root's quotient, so it is a yardstick of speed, not the same function).
Prints one JSON line per field, then the compiler's report of the build
and, last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM = 3.35e12           # bytes/s
BYTES_PER_ELEMENT = 28  # p, g, m, v read; p, m, v written


def groups_of(deform_type: str, dev, capacity: int = 200_000,
              n_points: int = 20_000):
    """A TrainState's three parameter groups (detached), their
    AdamStates, a gradient for every leaf and the step's learning rates."""
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import (gauss_lr_tree, gauss_trainable,
                                           init_train_state, mlp_trainable,
                                           node_trainable)
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    cols = rs.uniform(0, 1, (n_points, 3)).astype(np.float32)
    cfg = TrainConfig(deform_type=deform_type, gaussian_capacity=capacity)
    st = init_train_state(cfg, pts, cols, device=dev)
    groups = [{k: p.detach() for k, p in g.items()} for g in (
        gauss_trainable(st.gauss), mlp_trainable(st.nodes),
        node_trainable(st.nodes))]
    gen = torch.Generator().manual_seed(1)
    grads = [{k: torch.randn(p.shape, generator=gen).to(dev) * 1e-3
              for k, p in g.items()} for g in groups]
    lrs = [gauss_lr_tree(cfg, 1.6e-6), 1e-4, 1e-4]
    return groups, [st.gauss_opt, st.mlp_opt, st.node_opt], grads, lrs


def clone(groups, opts):
    """Copies of the groups' parameters and of their AdamStates."""
    from d2dgs_torch.train.optim import AdamState
    return ([{k: p.clone() for k, p in g.items()} for g in groups],
            [AdamState({k: m.clone() for k, m in o.mu.items()},
                       {k: v.clone() for k, v in o.nu.items()},
                       o.count.clone()) for o in opts])


def _device_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def measure(dev: torch.device, reps: int = 20) -> list[dict]:
    """One dict per field (node, hash, mlp) at its cell's shapes."""
    from d2dgs_torch.ops.cuda.adam import adam_step
    from d2dgs_torch.train.optim import adam_update, adam_update_plain
    out = []
    for deform_type in ("node", "hash", "mlp"):
        groups, opts, grads, lrs = groups_of(deform_type, dev)
        ref_groups, ref_opts = clone(groups, opts)

        def step(update, groups=groups, opts=opts):
            for i, (g, gr, lr) in enumerate(zip(groups, grads, lrs)):
                opts[i] = update(gr, opts[i], g, lr)

        before = adam_step.launches
        step(adam_update)
        launches = adam_step.launches - before
        step(adam_update_plain, ref_groups, ref_opts)
        torch.cuda.synchronize()
        bitwise = all(
            torch.equal(a, b) for ga, oa, gb, ob in zip(groups, opts,
                                                         ref_groups, ref_opts)
            for k in ga for a, b in ((ga[k], gb[k]), (oa.mu[k], ob.mu[k]),
                                     (oa.nu[k], ob.nu[k])))
        elements = sum(p.numel() for g in groups for p in g.values())
        lib_params = [[torch.nn.Parameter(p.clone()) for p in g.values()]
                      for g in groups]
        for ps, gr in zip(lib_params, grads):
            for p, g in zip(ps, gr.values()):
                p.grad = g
        lib = torch.optim.Adam(
            [{"params": ps, "lr": 1e-4} for ps in lib_params], eps=1e-15,
            fused=True)
        bound_ms = elements * BYTES_PER_ELEMENT / HBM * 1e3
        res = {
            "field": deform_type,
            "leaves": [len(g) for g in groups], "elements": elements,
            "bitwise_plain": bitwise, "launches_per_step": launches,
            "ms": _device_ms(lambda: step(adam_update), reps),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "host_ms": _host_ms(lambda: step(adam_update), reps),
            "plain_ms": _device_ms(
                lambda: step(adam_update_plain, ref_groups, ref_opts),
                max(3, reps // 4)),
            "plain_host_ms": _host_ms(
                lambda: step(adam_update_plain, ref_groups, ref_opts),
                max(3, reps // 4)),
            "library_ms": _device_ms(lib.step, reps),
        }
        res["roofline_pct"] = 100 * bound_ms / res["ms"]
        out.append(res)
        del groups, opts, grads, ref_groups, ref_opts, lib, lib_params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adam_time: needs a CUDA device", file=sys.stderr)
        return 1
    from d2dgs_torch.ops.cuda import build
    from d2dgs_torch.ops.cuda.adam import SOURCE
    _, report = build.build(SOURCE)
    for res in measure(torch.device("cuda"), args.reps):
        print(json.dumps(res), flush=True)
    print(report.strip())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
