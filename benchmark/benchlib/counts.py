"""Frozen operation and byte counts of the work a cell needs, and the
peaks they are held against.  The blend's counts per (pair, pixel) are
``chip_smoke.py``'s (``OPS_EVAL``, ``OPS_BLEND``, ``OPS_BWD_BLEND``,
``fwd_bound``, ``bwd_bound``), applied here to the pairs the plain
reference's sequential walk evaluates and blends on the cell's own
views, never to counts the port reports.  The rest are counted from the
configuration's widths and the image size.
"""
from __future__ import annotations

import math

from .scene import field_shapes

# one H100 SXM (NVIDIA data sheet): float32 outside the tensor cores, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float32 operations per (pair, pixel) of the blend walk: the response of
# every evaluated pair (ray-splat intersection, low-pass, exp, masks), the
# compositing of every blended pair; the backward repeats the response of
# every pair up to a pixel's last blended one and adds, per blended pair,
# the pre-state rebuild, the cotangents, the response adjoint and the
# running sums (143) and its 18 gradients (18)
OPS_EVAL = 46
OPS_BLEND = 39
OPS_BWD_BLEND = 143 + 18
NFEAT = 18          # floats of a pair's features
NSTATE = 16         # state rows per pixel the forward writes
NCKPT = 11          # accumulators a training forward checkpoints
PIX = 256
# per surfel: the deformed parameters, SH of degree 3, the surfel ->
# screen transform, the AABB and the visibility circle (counted from
# render(): ~60 + ~150 + ~120 + ~70)
OPS_SURFEL = 400
# per pixel of the 3-channel image: the L1, the SSIM map's arithmetic
# (besides its five blurs), the normal-consistency and distortion terms
# and the depth -> normal finite differences
OPS_LOSS_PIXEL = 3 * 6 + 3 * 20 + 40
# Adam per parameter element: the two moments (4 + 4), the bias
# corrections, the square root, the division and the update (6)
OPS_ADAM = 14


def blend_fwd(walk: dict, train: bool) -> dict:
    """K1's least work for the walk counts ``walk`` (``reference.render``):
    its operations, and its bytes: the sorted features, pair ranks and
    tile ranges read once, the state rows (and in training the records
    and checkpoints) written once."""
    ops = OPS_EVAL * walk["n_eval"] + OPS_BLEND * walk["n_blend"]
    nbytes = (walk["n_sorted"] * NFEAT * 4 + walk["n_pairs"] * 4
              + walk["n_tiles"] * 8 + walk["n_tiles"] * NSTATE * PIX * 4)
    if train:
        nbytes += walk["n_tiles"] * 2 * PIX * 4 + \
            walk["n_ckpt"] * NCKPT * PIX * 4
    return {"ops": ops, "bytes": nbytes}


def blend_bwd(walk: dict) -> dict:
    """K2's least work: every pair up to each pixel's last blended one
    re-evaluated, every blended pair's adjoint; the features, pair ranks,
    tile ranges, the state, records, cotangent and checkpoint rows read
    once and the feature gradients written once."""
    ops = OPS_EVAL * walk["n_walk_bwd"] + OPS_BWD_BLEND * walk["n_blend"]
    nbytes = (2 * walk["n_sorted"] * NFEAT * 4 + walk["n_pairs"] * 4
              + walk["n_tiles"] * 8
              + walk["n_tiles"] * PIX * 4 * (3 + 2 + NCKPT)
              + walk["n_ckpt"] * NCKPT * PIX * 4)
    return {"ops": ops, "bytes": nbytes}


def least_seconds(work: dict) -> float:
    return max(work["ops"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES_S)


def field_fwd_ops(cfg: dict, n_live: int) -> tuple[float, float]:
    """Operations of the deformation field's forward for ``n_live``
    surfels (``fields/<deform_type>.py``): (those that are
    differentiated, those that are not: the node field's choice of the
    nearest nodes)."""
    from .fields import field
    return field(cfg["deform_type"]).fwd_ops(cfg, n_live)


def field_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in field_shapes(cfg))


def surfel_params(cfg: dict, n_live: int) -> int:
    k = (cfg["sh_degree"] + 1) ** 2
    return n_live * (3 + 3 * k + 2 + 4 + 1 + cfg["hyper_dim"] + 1)


def loss_ops(H: int, W: int) -> float:
    """The losses forward: SSIM's five separable 11 + 11-tap blurs over 3
    channels and the per-pixel arithmetic."""
    return H * W * (5 * 3 * 2 * 22 + OPS_LOSS_PIXEL)


def train_step_ops(cfg: dict, walk: dict, n_live: int, H: int,
                   W: int) -> float:
    """The whole main-stage step: forward and backward (twice the
    forward's operations) of the field, the surfels' projection and the
    losses, K1 and K2's walks, Adam over every parameter element."""
    grad, nograd = field_fwd_ops(cfg, n_live)
    fwd = grad + OPS_SURFEL * n_live
    # the loss's backward runs the three blurs that depend on the render
    loss = loss_ops(H, W) + H * W * 3 * 2 * 22 * 3
    adam = OPS_ADAM * (surfel_params(cfg, n_live) + field_params(cfg))
    return 3.0 * fwd + nograd + loss + blend_fwd(walk, True)["ops"] + \
        blend_bwd(walk)["ops"] + adam


def view_ops(cfg: dict, walk: dict, n_live: int) -> float:
    """One served view: the field's and the surfels' forward and K1."""
    return sum(field_fwd_ops(cfg, n_live)) + OPS_SURFEL * n_live + \
        blend_fwd(walk, False)["ops"]
