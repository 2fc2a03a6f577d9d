"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference``), at the timed sizes.

Training: the step's loss (its L1, which the step reports) at each of the
first three steps; per leaf, the norm of the first gradient as Adam got
it (its first moment over 1 - beta1) and the norm of the leaf's change
over the three steps, each as the gap between the port's norm and the
reference's over the larger of the reference's norm of that leaf and of
the median leaf, the worst leaf counting.  Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
round-off alone, and are left out of the change.

Serving: the 8-bit images handed to the user against the reference's, on
a sample of the window's views drawn from the seed: the share of 8-bit
values that differ (worst view) and the largest difference in levels.

Numbers whose name starts with "_" are reported beside, not judged.
"""
from __future__ import annotations

import statistics

import torch

ROUNDOFF_LEAF = 1e-3


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """|‖prog[k]‖ - ‖ref[k]‖| / max(‖ref[k]‖, median ‖ref‖) per leaf."""
    rn = {k: _norm(v) for k, v in ref.items()}
    med = statistics.median(rn.values())
    return {k: abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
            for k in ref if k not in skip}


def norm_gap(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's gap (``leaf_gaps``); NaN counts as the worst."""
    gaps = leaf_gaps(prog, ref, skip).values()
    if any(g != g for g in gaps):
        return float("nan")
    return max(gaps, default=0.0)


def roundoff_leaves(grads: dict) -> set:
    rn = {k: _norm(v) for k, v in grads.items()}
    med = statistics.median(rn.values())
    return {k for k, v in rn.items() if v < ROUNDOFF_LEAF * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"l1": [3 floats], "g1": {leaf: first gradient},
    "delta": {leaf: change over three steps}}."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["l1"], ref["l1"]))
    if any(p != p for p in prog["l1"]):
        loss = float("nan")
    skip = roundoff_leaves(ref["g1"])
    g_gap = norm_gap(prog["g1"], ref["g1"])
    d_gap = norm_gap(prog["delta"], ref["delta"], skip)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
    return {"loss_gap": loss, "grad_gap": g_gap, "update_gap": d_gap,
            "_l1": {"port": prog["l1"], "reference": ref["l1"]},
            "_worst": {"grad": top(leaf_gaps(prog["g1"], ref["g1"])),
                       "update": top(leaf_gaps(prog["delta"], ref["delta"],
                                               skip))},
            "_skipped": sorted(skip)}


def serve_numbers(pairs: list) -> dict:
    """``pairs``: (port's uint8 image, reference's) per sampled view."""
    share, level = 0.0, 0
    for a, b in pairs:
        a, b = a.to(torch.int16), b.to(a.device).to(torch.int16)
        d = (a - b).abs()
        share = max(share, float((d > 0).double().mean()))
        level = max(level, int(d.max()))
    return {"pixel_diff_share": share, "max_level_diff": level}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    finite and within it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks
