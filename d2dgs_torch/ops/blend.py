"""Front-to-back surfel alpha blending as chunk math (counterpart of
d2dgs_tpu/ops/blend.py, reference forward.cu:265-463).

A chunk of G depth-sorted Gaussians is blended against P pixels with
one exclusive cumprod along the Gaussian axis plus weighted sums.  Early
termination (T < 1e-4) and the 1/255 alpha cutoff are reproduced with
prefix masks, including the reference's rule that the Gaussian that
crosses the threshold is dropped.  Every function takes optional leading
batch dimensions (the tiled blend batches over tiles).  This is the plain
PyTorch version of the blend; the CUDA kernel (ops/cuda/blend.py) walks
the same recurrences one Gaussian at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import (ALPHA_CLIP, ALPHA_CUTOFF, FAR_PLANE, FILTER_INV_SQUARE,
                      NEAR_PLANE, T_CUTOFF)


def pixel_responses(T: torch.Tensor, center: torch.Tensor,
                    opacity: torch.Tensor, pix: torch.Tensor):
    """Ray-splat intersection for G Gaussians x P pixels.

    T: [..., G,3,3] rows (Tu,Tv,Tw); center: [..., G,2]; opacity: [..., G];
    pix: [..., P,2] pixel centers (x+0.5, y+0.5).
    Returns (alpha [..., G,P], depth [..., G,P]); alpha is already masked
    by the p.z==0 / near-plane / 1-255 cutoff rules.
    """
    col = lambda a, i, j: a[..., :, i, j, None]        # [..., G,1]
    px = pix[..., None, :, 0]                           # [..., 1,P]
    py = pix[..., None, :, 1]
    # two homogeneous planes through the ray (2DGS Eq. 8-10)
    kx = px * col(T, 2, 0) - col(T, 0, 0)
    ky = px * col(T, 2, 1) - col(T, 0, 1)
    kz = px * col(T, 2, 2) - col(T, 0, 2)
    lx = py * col(T, 2, 0) - col(T, 1, 0)
    ly = py * col(T, 2, 1) - col(T, 1, 1)
    lz = py * col(T, 2, 2) - col(T, 1, 2)
    # homogeneous intersection point p = k x l
    p_x = ky * lz - kz * ly
    p_y = kz * lx - kx * lz
    p_z = kx * ly - ky * lx
    good = p_z != 0.0
    inv_pz = torch.where(good, 1.0 / torch.where(good, p_z, 1.0), 0.0)
    sx = p_x * inv_pz
    sy = p_y * inv_pz
    rho3d = sx * sx + sy * sy
    dx = center[..., :, 0, None] - px
    dy = center[..., :, 1, None] - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)   # low-pass (2DGS Eq.11)
    rho = torch.minimum(rho3d, rho2d)
    use3d = rho3d <= rho2d
    depth = torch.where(use3d,
                        sx * col(T, 2, 0) + sy * col(T, 2, 1) + col(T, 2, 2),
                        col(T, 2, 2))
    alpha = torch.clamp_max(opacity[..., :, None] * torch.exp(-0.5 * rho),
                            ALPHA_CLIP)
    keep = good & (depth >= NEAR_PLANE) & (alpha >= ALPHA_CUTOFF)
    return torch.where(keep, alpha, 0.0), depth


class BlendState(NamedTuple):
    """Per-pixel accumulators carried across Gaussian chunks, [..., P]
    or [..., P, 3]."""
    T: torch.Tensor           # transmittance
    done: torch.Tensor        # bool: early-terminated
    color: torch.Tensor       # [..., P,3]
    depth: torch.Tensor       # expected-depth accumulator
    normal: torch.Tensor      # [..., P,3]
    dist1: torch.Tensor       # sum w*m  (m = mapped depth)
    dist2: torch.Tensor       # sum w*m^2
    distortion: torch.Tensor
    med_depth: torch.Tensor
    med_weight: torch.Tensor
    n_eval: torch.Tensor      # pairs evaluated (up to and with the trigger)
    n_blend: torch.Tensor     # pairs blended (alpha > 0, before the trigger)
    # with ``positions``: the positions in the pair list of the last
    # blended pair and of the median pair (-1 for none), int64
    last: torch.Tensor | None = None
    med: torch.Tensor | None = None
    # with ``decisions``: the transmittances the walk's threshold tests
    # read (NaN where there is none): before and after the median pair
    # (T > 0.5 chose it), the pairs blended up to and with it, and T
    # after the pair that tripped the termination (T < T_CUTOFF)
    t_med: torch.Tensor | None = None
    t_med_after: torch.Tensor | None = None
    n_med: torch.Tensor | None = None
    t_trip: torch.Tensor | None = None


def init_state(shape, device=None, dtype=torch.float32,
               positions: bool = False, decisions: bool = False
               ) -> BlendState:
    """shape: the pixel shape (..., P).  ``positions``: also track the
    last blended and the median pair's positions (``BlendState.last`` and
    ``med``); ``decisions``: the transmittances of the threshold tests
    (``t_med``, ``t_med_after``, ``n_med``, ``t_trip``)."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    z3 = torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)
    none = torch.full(shape, -1, dtype=torch.int64, device=device) \
        if positions else None
    nan = torch.full(shape, float("nan"), dtype=dtype, device=device) \
        if decisions else None
    return BlendState(
        T=torch.ones(shape, dtype=dtype, device=device),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        color=z3, depth=z, normal=z3.clone(), dist1=z, dist2=z,
        distortion=z, med_depth=z, med_weight=z, n_eval=z, n_blend=z,
        last=none, med=none, t_med=nan, t_med_after=nan,
        n_med=None if nan is None else z, t_trip=nan)


def _ex_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum along the Gaussian axis (-2)."""
    return torch.cat([torch.zeros_like(x[..., :1, :]),
                      torch.cumsum(x, dim=-2)[..., :-1, :]], dim=-2)


def blend_chunk(state: BlendState, alpha: torch.Tensor, depth: torch.Tensor,
                color: torch.Tensor, normal: torch.Tensor,
                n_rows: torch.Tensor | None = None,
                offset: int = 0) -> BlendState:
    """Composite a depth-sorted chunk.

    alpha/depth: [..., G,P] (alpha pre-masked, 0 => skip);
    color/normal: [..., G,3]; n_rows: [...] count of real (not padding)
    rows, for the ``n_eval`` counter (default G); offset: the position of
    the chunk's first row in the pair list (for ``state.last``/``med``).
    """
    g = alpha.shape[-2]
    one_minus = 1.0 - alpha
    # transmittance *before* each Gaussian (exclusive cumulative product)
    cp = torch.cumprod(one_minus, dim=-2)
    T_before = state.T[..., None, :] * torch.cat(
        [torch.ones_like(cp[..., :1, :]), cp[..., :-1, :]], dim=-2)
    T_after = T_before * one_minus
    # termination: the Gaussian whose blend would push T below the cutoff
    # is itself dropped, and everything after it (forward.cu:400-405)
    trig = (alpha > 0.0) & (T_after < T_CUTOFF)
    any_trig = torch.any(trig, dim=-2)
    idx = torch.arange(g, device=alpha.device)[:, None]
    first = torch.amin(torch.where(trig, idx, g), dim=-2)
    include = (idx < first[..., None, :]) & ~state.done[..., None, :]
    w = torch.where(include, alpha * T_before, 0.0)     # [..., G,P]

    color_acc = state.color + torch.einsum("...gp,...gc->...pc", w, color)
    normal_acc = state.normal + torch.einsum("...gp,...gc->...pc", w, normal)
    depth_acc = state.depth + torch.sum(w * depth, dim=-2)

    # distortion (forward.cu:408-428): per-Gaussian error
    # m^2*A + dist2 - 2*m*dist1 with the pre-blend accumulators;
    # A == 1 - T_before (telescoping sum of weights)
    safe_d = torch.where(depth != 0.0, depth, 1.0)
    m = (FAR_PLANE * depth - FAR_PLANE * NEAR_PLANE) / (
        (FAR_PLANE - NEAR_PLANE) * safe_d)
    wm = w * m
    wmm = wm * m
    dist1_b = state.dist1[..., None, :] + _ex_cumsum(wm)
    dist2_b = state.dist2[..., None, :] + _ex_cumsum(wmm)
    err = m * m * (1.0 - T_before) + dist2_b - 2.0 * m * dist1_b
    distortion = state.distortion + torch.sum(err * w, dim=-2)

    # median depth: the *last* blended Gaussian whose pre-blend T > 0.5
    med_cond = include & (alpha > 0.0) & (T_before > 0.5)
    has_med = torch.any(med_cond, dim=-2)
    last = torch.clamp_min(torch.amax(torch.where(med_cond, idx, -1), dim=-2),
                           0)[..., None, :]
    md = torch.gather(depth, -2, last)[..., 0, :]
    mw = torch.gather(w, -2, last)[..., 0, :]

    rows = g if n_rows is None else n_rows[..., None]
    evaluated = torch.where(any_trig, first + 1, rows)
    pos_last, pos_med = state.last, state.med
    if pos_last is not None:
        blended = include & (alpha > 0.0)
        last_b = torch.amax(torch.where(blended, idx, -1), dim=-2)
        pos_last = torch.where(last_b >= 0, offset + last_b, pos_last)
        pos_med = torch.where(has_med, offset + last[..., 0, :], pos_med)
    dec = (state.t_med, state.t_med_after, state.n_med, state.t_trip)
    if state.t_trip is not None:
        blended_n = torch.cumsum((include & (alpha > 0.0)).to(alpha.dtype),
                                 dim=-2)
        at = lambda x, i: torch.gather(x, -2, i)[..., 0, :]
        trip = any_trig & ~state.done
        dec = (torch.where(has_med, at(T_before, last), state.t_med),
               torch.where(has_med, at(T_after, last), state.t_med_after),
               torch.where(has_med, state.n_blend + at(blended_n, last),
                           state.n_med),
               torch.where(trip, at(T_after, torch.clamp_max(
                   first, g - 1)[..., None, :]), state.t_trip))
    return BlendState(
        T=state.T * torch.prod(torch.where(include, one_minus, 1.0), dim=-2),
        done=state.done | any_trig,
        color=color_acc, depth=depth_acc, normal=normal_acc,
        dist1=state.dist1 + torch.sum(wm, dim=-2),
        dist2=state.dist2 + torch.sum(wmm, dim=-2),
        distortion=distortion,
        med_depth=torch.where(has_med, md, state.med_depth),
        med_weight=torch.where(has_med, mw, state.med_weight),
        n_eval=state.n_eval + torch.where(state.done, 0.0,
                                          evaluated.to(alpha.dtype)),
        n_blend=state.n_blend + torch.sum(include & (alpha > 0.0), dim=-2,
                                          dtype=alpha.dtype),
        last=pos_last, med=pos_med, t_med=dec[0], t_med_after=dec[1],
        n_med=dec[2], t_trip=dec[3],
    )


def finalize(state: BlendState, bg: torch.Tensor):
    """-> (color [..., P,3], allmap [..., P,8]) in the reference channel
    layout."""
    color = state.color + state.T[..., None] * bg
    allmap = torch.cat([
        state.depth[..., None],
        (1.0 - state.T)[..., None],
        state.normal,
        state.med_depth[..., None],
        state.distortion[..., None],
        state.med_weight[..., None],
    ], dim=-1)
    return color, allmap
