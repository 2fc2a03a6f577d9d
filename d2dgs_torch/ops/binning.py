"""Tile binning sized from the measured counts (counterpart of
d2dgs_tpu/ops/binning.py, reference rasterizer_impl.cu:70-138,196-342).

1. Gaussians are depth-sorted once (stable sort on view z, invalid
   splats last), as the CUDA sort of depth bits.
2. Flat emission (duplicateWithKeys): every valid splat emits its full
   tile rect into one buffer whose size is the exact total, so nothing is
   ever dropped (``Binning.clamped`` is always 0).
3. Pairs failing the exact visibility-circle cull are removed, and the
   rest sorted by one int64 (tile, depth-rank) key; keys are unique, so
   the order is the JAX package's bit for bit.
4. Per-tile [start, count) ranges come from ``torch.searchsorted``.

Pairs are stored as depth ranks (indices into ``order``); consumers
pre-sort per-Gaussian features by ``order`` once and index them with
``pair_rank``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..config import TILE, RasterConfig
from .projection import Preprocessed


def circle_tile_overlap(center: torch.Tensor, r2, tx, ty,
                        pixel_offset: float = 0.5):
    """True where a splat's visibility circle touches tile (tx, ty): the
    squared distance from ``center`` to the tile's sample rect is <= r2."""
    x0 = tx.to(torch.float32) * TILE + pixel_offset
    y0 = ty.to(torch.float32) * TILE + pixel_offset
    cx = center[..., 0]
    cy = center[..., 1]
    dx = cx - torch.minimum(torch.maximum(cx, x0), x0 + (TILE - 1.0))
    dy = cy - torch.minimum(torch.maximum(cy, y0), y0 + (TILE - 1.0))
    return dx * dx + dy * dy <= r2


class Binning(NamedTuple):
    order: torch.Tensor       # [N] int32 gaussian index by ascending depth
    pair_rank: torch.Tensor   # [B] int32 sorted-pair depth ranks
    tile_start: torch.Tensor  # [T] int32 offset into pair arrays
    tile_count: torch.Tensor  # [T] int32
    num_pairs: torch.Tensor   # 0-d int32 (== B)
    clamped: torch.Tensor     # 0-d int32, always 0 (exact-size emission)

    @property
    def pair_gid(self) -> torch.Tensor:
        """[B] gaussian ids (original index space)."""
        return self.order[self.pair_rank.long()]


def opacity_radius(radius: torch.Tensor, opacity: torch.Tensor,
                   sigma: torch.Tensor | None = None) -> torch.Tensor:
    """Exact visibility radius of the conic (3DGS) blend law.

    A pixel is kept only when alpha = op*exp(-rho/2) >= 1/255, i.e.
    rho <= 2L with L = ln(255*op); rho >= d^2 / lambda_max, so
    d <= sigma_max * sqrt(2L).  ``sigma``: sigma_max per splat, by
    default radius/3 (exact for the 3DGS radius ceil(3*sqrt(lambda_max))).
    The sqrt(L) term only widens the bound.  0 where op < 1/255."""
    op = opacity.detach().to(torch.float32)
    L = torch.clamp_min(torch.log(torch.clamp_min(255.0 * op, 1e-12)), 0.0)
    sig = (radius.to(torch.float32) / 3.0 if sigma is None
           else sigma.detach().to(torch.float32))
    vis = torch.maximum(sig * torch.sqrt(2.0 * L), torch.sqrt(L))
    return torch.where(op >= 1.0 / 255.0, vis, torch.zeros_like(vis))


class VisCircles(NamedTuple):
    """Exact visibility circle of the surfel blend, [N]-shaped in the
    original index space."""
    center: torch.Tensor     # [N,2] enclosing circle center
    radius: torch.Tensor     # [N]   enclosing circle radius
    cullable: torch.Tensor   # [N]   bool: the circle is a valid bound
    cull_all: torch.Tensor   # [N]   bool: opacity < 1/255, nothing visible


def visibility_circles(prep: Preprocessed, opacity) -> VisCircles:
    """Exact visibility-region bound of the surfel blend law.

    A pixel has alpha = op*exp(-rho/2) >= 1/255 only when
    rho = min(rho3d, rho2d) <= 2L, L = ln(255*op): inside the low-pass
    circle |pix - center| <= sqrt(L), or inside the level set
    {rho3d <= 2L}, an ellipse whose bounding data comes from the dual-form
    AABB trick with the splat axes scaled by sqrt(2L).  The two circles
    are merged into their smallest enclosing circle.  ``cullable`` is
    False where the level set is not a bounded ellipse (callers must not
    cull those); ``cull_all`` marks op < 1/255.
    """
    op = opacity.detach().to(torch.float32)
    L = torch.clamp_min(torch.log(torch.clamp_min(255.0 * op, 1e-12)), 0.0)
    rho = 2.0 * L
    T = prep.T.detach().to(torch.float32)
    Tu, Tv, Tw = T[:, 0, :], T[:, 1, :], T[:, 2, :]

    d = rho * (Tw[:, 0] ** 2 + Tw[:, 1] ** 2) - Tw[:, 2] ** 2
    good = d != 0.0
    inv_d = torch.where(good, 1.0 / torch.where(good, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    frho = rho * inv_d
    fz = -inv_d
    dot2 = lambda A, B: frho * (A[:, 0] * B[:, 0] + A[:, 1] * B[:, 1]) \
        + fz * A[:, 2] * B[:, 2]
    cx = dot2(Tu, Tw)
    cy = dot2(Tv, Tw)
    vxx = cx * cx - dot2(Tu, Tu)
    vyy = cy * cy - dot2(Tv, Tv)
    vxy = cx * cy - dot2(Tu, Tv)
    mid = 0.5 * (vxx + vyy)
    dif = 0.5 * (vxx - vyy)
    lam = mid + torch.sqrt(torch.clamp_min(dif * dif + vxy * vxy, 0.0))
    # +1e-2 px pad absorbs float rounding at the alpha-cutoff boundary
    r_lv = torch.sqrt(torch.clamp_min(lam, 0.0)) + 1e-2
    cullable = good & (vxx >= 0.0) & (vyy >= 0.0)

    # smallest circle enclosing the level circle and the low-pass circle
    c_lp = prep.center.detach().to(torch.float32)
    r_lp = torch.sqrt(L) + 1e-2
    c_lv = torch.stack([cx, cy], dim=-1)
    delta = c_lv - c_lp
    dd = torch.sqrt(delta[:, 0] ** 2 + delta[:, 1] ** 2)
    t = torch.clamp((dd + r_lv - r_lp) / torch.clamp_min(2.0 * dd, 1e-12),
                    0.0, 1.0)
    center_u = c_lp + t[:, None] * delta
    radius_u = torch.maximum(t * dd + r_lp, (1.0 - t) * dd + r_lv)
    return VisCircles(center=center_u, radius=radius_u, cullable=cullable,
                      cull_all=op < 1.0 / 255.0)


def circles_tile_hit(vc: VisCircles, tx, ty, pixel_offset: float = 0.5):
    """Per-(splat, tile) keep-mask from the exact visibility circle
    (``vc`` fields already broadcast against tx/ty)."""
    hit = circle_tile_overlap(vc.center, vc.radius * vc.radius, tx, ty,
                              pixel_offset)
    return (hit | ~vc.cullable) & ~vc.cull_all


def required_emission(prep: Preprocessed) -> torch.Tensor:
    """Total tile-rect slots over valid splats (the reference's
    ``num_rendered``): the size of the flat emission."""
    rw = prep.rect_max[:, 0] - prep.rect_min[:, 0]
    rh = prep.rect_max[:, 1] - prep.rect_min[:, 1]
    return torch.sum(torch.where(prep.valid, rw * rh, torch.zeros_like(rw)))


def emission_slots(area: torch.Tensor):
    """Flat-emission slot->run map for runs of ``area[i]`` slots each.

    Returns (g [total] int64 row index per slot, offs [N] int64 exclusive
    offsets, total int).  The buffer is exactly ``total`` long."""
    area = area.to(torch.int64)
    offs = torch.cumsum(area, 0) - area
    trace.count("host.reads", 2)  # the repeats' check, then their total
    g = torch.repeat_interleave(
        torch.arange(area.shape[0], device=area.device), area)
    return g, offs, g.shape[0]


# signed-r^2 sentinels of the circle test
_NO_CULL = 1e30    # circle always hits
_CULL_ALL = -1.0   # circle never hits


def bin_gaussians(prep: Preprocessed, grid_x: int, grid_y: int,
                  cfg: RasterConfig, opacity=None, cull_sigma=None,
                  pixel_offset: float = 0.5) -> Binning:
    """Bin splats into per-tile depth-ordered pair lists.

    ``opacity`` enables the output-invariant circle cull (see
    ``visibility_circles``); without it every rect tile is kept, as the
    reference's getRect.  ``cull_sigma``: per-splat sigma_max ([N]) of
    the conic (3DGS) law, whose circle ``opacity_radius`` is then exact.
    ``pixel_offset``: sample-rect convention of the consuming blend
    (0.5 = pixel centers, 0.0 = corners)."""
    n = prep.depth.shape[0]
    dev = prep.depth.device
    num_tiles = grid_x * grid_y

    depth_key = torch.where(prep.valid, prep.depth,
                            torch.full_like(prep.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices

    # per-splat visibility circle as (cx, cy, signed r^2)
    if cfg.tile_circle_cull and opacity is not None and \
            cull_sigma is not None:
        r_bin = opacity_radius(prep.radius, opacity, sigma=cull_sigma)
        sr2 = torch.where(opacity.detach().to(torch.float32) >= 1.0 / 255.0,
                          r_bin * r_bin, torch.full_like(r_bin, _CULL_ALL))
        ccen = prep.center.detach().to(torch.float32)
    elif cfg.tile_circle_cull and opacity is not None:
        vc = visibility_circles(prep, opacity)
        sr2 = torch.where(vc.cull_all,
                          torch.full_like(vc.radius, _CULL_ALL),
                          torch.where(vc.cullable, vc.radius * vc.radius,
                                      torch.full_like(vc.radius, _NO_CULL)))
        ccen = vc.center
    else:
        sr2 = torch.full((n,), _NO_CULL, dtype=torch.float32, device=dev)
        ccen = torch.zeros((n, 2), dtype=torch.float32, device=dev)

    rmin = prep.rect_min[order]
    rmax = prep.rect_max[order]
    rw = rmax[:, 0] - rmin[:, 0]
    rh = rmax[:, 1] - rmin[:, 1]
    area = torch.where(prep.valid[order], rw * rh, torch.zeros_like(rw))

    # flat depth-major emission: slot e belongs to depth rank g[e]
    g, offs, _ = emission_slots(area)
    slot = torch.arange(g.shape[0], device=dev) - offs[g]
    sw = torch.clamp_min(rw, 1).to(torch.int64)[g]
    tx = rmin[g, 0].to(torch.int64) + slot % sw
    ty = rmin[g, 1].to(torch.int64) + slot // sw

    keep = circle_tile_overlap(ccen[order][g], sr2[order][g], tx, ty,
                               pixel_offset)

    # sort by the fused (tile, depth-rank) key: unique keys, so any sort
    # gives the one order (the CUDA key is tile<<32 | depth bits)
    rank_bits = max((n - 1).bit_length(), 1)
    key = ((ty * grid_x + tx) << rank_bits) + g
    trace.count("host.reads", 1)  # the kept count sizes key[keep]
    skey = torch.sort(key[keep]).values
    sorted_tile = skey >> rank_bits
    pair_rank = (skey & ((1 << rank_bits) - 1)).to(torch.int32)

    tile_edges = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev), side="left")
    tile_start = tile_edges[:-1].to(torch.int32)
    tile_count = (tile_edges[1:] - tile_edges[:-1]).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return Binning(order=order.to(torch.int32), pair_rank=pair_rank,
                   tile_start=tile_start, tile_count=tile_count,
                   num_pairs=tile_edges[-1].to(torch.int32),
                   clamped=zero)
