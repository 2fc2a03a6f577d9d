"""The node warp's gather backward (csrc/node_gather.cu) at a node training
step's shapes, on one NVIDIA GPU: its error against the plain PyTorch
version and a float64 sum, whether two calls give the same bits, and its
time beside its bound, the plain version and aten's indexing backward.

Run from the repository root:  python3 tools/node_gather_time.py
(chip_smoke.py imports ``measure`` for its ``kernels`` line.)

The shapes are those a dnerf-node training step gives it: the field runs
on the live surfels only (``models/deform.py`` ``deform_gaussians``), so
the 83,252 live rows, each bound to K = 3 of 1,024 nodes drawn at random
and each with a gradient, gather the [1024, 13] pack of
``cal_nn_weight`` and the [1024, 18] table of ``warp``.  Each time is
the mean of ``--reps`` launches between two CUDA events after a
warm-up.  The bound is the bytes the call must move (the gradient rows
and indices read once, the table's gradient written once) over
3.35 TB/s, the H100 SXM's HBM.
Prints one JSON line per table width, then the compiler's report of the
build and, last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]
# HBM bandwidth (bytes/s), as the benchmark's rooflines take it
from benchlib.counts import PEAK_BYTES_S  # noqa: E402

N, K, M = 83_252, 3, 1024


def _ms(fn, reps: int) -> float:
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


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float(torch.linalg.vector_norm(got.double() - ref)
                 / torch.linalg.vector_norm(ref))


def measure(dev: torch.device, reps: int = 50) -> list[dict]:
    """One dict per table width (13, 18) at node-train's live rows."""
    from d2dgs_torch.ops.cuda.node_gather import (bwd_plan, gather_bwd,
                                                  scatter_rows_plain)
    gen = torch.Generator().manual_seed(0)
    out = []
    for c in (13, 18):
        idx = torch.randint(0, M, (N, K), generator=gen).to(dev)
        g = torch.randn((N, K, c), generator=gen).to(dev)
        with torch.cuda.device(dev):
            plan = bwd_plan(N * K, M, c)
        grad = gather_bwd(g, idx, M)
        sum64 = torch.zeros((M, c), dtype=torch.float64, device=dev)
        sum64.index_add_(0, idx.reshape(-1), g.reshape(-1, c).double())
        bound_ms = (N * K * (c * 4 + 8) + M * c * 4) / PEAK_BYTES_S * 1e3
        res = {
            "table": [M, c], "rows": [N, K], "plan": list(plan),
            "rel_err_plain": _rel(grad, scatter_rows_plain(g, idx, M)),
            "rel_err_float64": _rel(grad, sum64),
            "bitwise_repeat": bool(torch.equal(grad, gather_bwd(g, idx, M))),
            "ms": _ms(lambda: gather_bwd(g, idx, M), reps),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "plain_ms": _ms(lambda: scatter_rows_plain(g, idx, M), reps),
            # aten's IndexBackward0: an accumulating index_put_ into zeros
            "library_ms": _ms(lambda: torch.zeros((M, c), device=dev)
                              .index_put_((idx,), g, accumulate=True),
                              max(3, reps // 10)),
        }
        res["roofline_pct"] = 100 * bound_ms / res["ms"]
        out.append(res)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("node_gather_time: needs a CUDA device", file=sys.stderr)
        return 1
    from d2dgs_torch.ops.cuda import build
    from d2dgs_torch.ops.cuda.node_gather import SOURCE
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
