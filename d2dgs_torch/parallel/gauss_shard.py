"""Gaussian-sharded and tile-sharded rendering with a tile-binning exchange
(counterpart of d2dgs_tpu/parallel/gauss_shard.py).

The Gaussians are sharded over the ranks of one group (the gauss axis):
each rank preprocesses its shard, emits flat (tile, depth, features)
records, routes them to the rank that owns the tile with
``all_to_all_single``, and blends its slab of tiles.  Tile ownership is
interleaved (tile t belongs to rank t % D), which balances the very
unequal tile loads.  The slab blend is the single-card kernel K1 (K2 in
its backward, ``ops/cuda/blend.py``) with the global-tile map ``gtile``:
local slab slots index the output, ``gtile`` gives each slot's pixels.
On CPU tensors it is the plain blend with the same map.

As in the JAX package, each (source, destination) pair of ranks sends a
fixed ``exchange_cap`` records; records past it are dropped and counted in
``overflow``, and ``measure_exchange_counts``/``suggest_exchange_cap``
size the cap from the scene.  The pipeline is differentiable: the
exchange's backward is the reverse exchange, and the gathered slabs are a
replicated value, so the gather's backward keeps this rank's slab's
cotangent (the gradient of a loss that every rank computes alike from
the image is then the unsharded one).  Every rank runs every collective
of the forward and of the backward, whatever its own shard holds.

``shard_render_core`` is the per-rank body (the sharded training step
calls it per data row); ``render_gauss_sharded`` wraps it for standalone
use.  With no process group (``group`` None) the collectives are the
identity and the path runs in one process at D = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RasterConfig
from ..data.cameras import Camera
from ..ops.binning import (_CULL_ALL, _NO_CULL, circle_tile_overlap,
                           emission_slots, visibility_circles)
from ..ops.projection import preprocess, tile_grid
from ..ops.tiled_raster import state_to_maps, tiles_to_image

NFEAT = 19  # T(9) + center(2) + normal(3) + color(3) + opacity(1) + depth(1)


class ShardRender(NamedTuple):
    image: torch.Tensor      # [H,W,3] (the same on every rank)
    allmap: torch.Tensor     # [H,W,8]
    overflow: torch.Tensor   # 0-d int64: records dropped at the exchange
    radii: torch.Tensor      # [n_local] this rank's screen radii


# ---------------------------------------------------------------- collectives

def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _Exchange(torch.autograd.Function):
    """blocks [D, cap, ...]: block d goes to rank d of the group; returns
    the block each rank sent here, by source.  The backward is the same
    exchange of the cotangents, back to their sources."""

    @staticmethod
    def forward(ctx, blocks, group):
        ctx.group = group
        return _all_to_all(blocks, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GatherSlabs(torch.autograd.Function):
    """Every rank's slab [myT, ...] stacked by rank [D, myT, ...], the same
    on every rank.  Its backward takes this rank's own slab's cotangent: the
    stacked slabs are a replicated value, whose cotangent every rank
    computes alike from the same loss (the JAX package's semantics for a
    replicated shard_map output), so the gradient is the unsharded one and
    the backward needs no collective.  ``anchor`` (this rank's sorted
    records) gets a zero cotangent, so the backward reaches the exchange
    on every rank, also one whose slab blended nothing and took no
    gradient: every rank runs every collective."""

    @staticmethod
    def forward(ctx, slab, anchor, group, n_dev, dev_id):
        ctx.dev_id = dev_id
        ctx.anchor = anchor.shape, anchor.dtype, anchor.device
        parts = [torch.empty_like(slab) for _ in range(n_dev)]
        dist.all_gather(parts, slab.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        d_slab = g[ctx.dev_id].contiguous() if ctx.needs_input_grad[0] \
            else None
        return (d_slab, torch.zeros(shape, dtype=dtype, device=device),
                None, None, None)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (the identity without one)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_rows(x: torch.Tensor, group, n_dev: int) -> torch.Tensor:
    """[D, ...] of every rank's ``x``, not differentiated."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(n_dev)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


# -------------------------------------------------------------- the pipeline

def _emit_records(prep, feats, grid_x: int, grid_y: int, n_dev: int,
                  cfg: RasterConfig, exchange_cap: int,
                  counts_only: bool = False, opacity=None):
    """Per rank: depth-sort the local Gaussians, emit their tile records
    and group them by destination rank (tile % n_dev).  Returns (blocks
    [n_dev, cap, NFEAT + 1] (the features, then the tile id as a float),
    valid [n_dev, cap] bool, overflow 0-d int64), or the per-destination
    counts [n_dev] when ``counts_only``.

    The emission is the single-card binning's (ops/binning.py
    ``bin_gaussians``): the flat depth-major emission of every valid
    splat's tile rect, less the tiles its visibility circle misses, so
    the sharded and the whole-grid paths blend the same pairs.  Within a
    destination the records keep that depth-major order; each
    destination takes its first ``exchange_cap`` and the rest count in
    ``overflow``."""
    n = prep.depth.shape[0]
    dev = prep.depth.device
    num_tiles = grid_x * grid_y
    depth_key = torch.where(prep.valid, prep.depth,
                            torch.full_like(prep.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    if cfg.tile_circle_cull and opacity is not None:
        # the single-card binning's visibility-circle test
        vc = visibility_circles(prep, opacity)
        sr2 = torch.where(vc.cull_all, torch.full_like(vc.radius, _CULL_ALL),
                          torch.where(vc.cullable, vc.radius * vc.radius,
                                      torch.full_like(vc.radius, _NO_CULL)))
        ccen = vc.center
    else:
        sr2 = torch.full((n,), _NO_CULL, dtype=torch.float32, device=dev)
        ccen = torch.zeros((n, 2), dtype=torch.float32, device=dev)

    rmin, rmax = prep.rect_min[order], prep.rect_max[order]
    rw = rmax[:, 0] - rmin[:, 0]
    rh = rmax[:, 1] - rmin[:, 1]
    area = torch.where(prep.valid[order], rw * rh, torch.zeros_like(rw))
    g, offs, _ = emission_slots(area)
    slot = torch.arange(g.shape[0], device=dev) - offs[g]
    sw = torch.clamp_min(rw, 1).to(torch.int64)[g]
    tx = rmin[g, 0].to(torch.int64) + slot % sw
    ty = rmin[g, 1].to(torch.int64) + slot // sw
    keep = circle_tile_overlap(ccen[order][g], sr2[order][g], tx, ty)
    tile = (ty * grid_x + tx)[keep]
    gid = order[g[keep]]
    dest = tile % n_dev
    if counts_only:
        return torch.bincount(dest, minlength=n_dev)

    # group by destination, depth-major within each
    perm = torch.sort(dest, stable=True).indices
    s_dest, s_tile, s_gid = dest[perm], tile[perm], gid[perm]
    edges = torch.searchsorted(s_dest, torch.arange(n_dev + 1, device=dev))
    start, end = edges[:-1], edges[1:]
    overflow = torch.sum(torch.clamp_min(end - start - exchange_cap, 0))
    # one sentinel record, so an empty emission still indexes
    s_tile = torch.cat([s_tile, s_tile.new_full((1,), num_tiles)])
    s_gid = torch.cat([s_gid, s_gid.new_zeros(1)])
    idx = start[:, None] + torch.arange(exchange_cap, device=dev)[None]
    ok = idx < end[:, None]
    idx = torch.where(ok, idx, s_tile.shape[0] - 1)
    blk_tile = torch.where(ok, s_tile[idx], num_tiles)
    # index_select: its backward adds with atomics, where advanced
    # indexing's sorts the indices and walks each repeated one serially
    # (every padding slot repeats the sentinel's)
    blk_feat = torch.where(
        ok[..., None],
        feats.index_select(0, s_gid[idx].reshape(-1)).view(
            n_dev, exchange_cap, -1), 0.0)
    blocks = torch.cat([blk_feat, blk_tile[..., None].to(torch.float32)],
                       dim=-1)
    return blocks, ok, overflow


def _sort_records(recs, rec_ok, my_tiles: int, num_tiles: int, n_dev: int,
                  dev_id: int):
    """Merge the exchanged records by (global tile, depth), stably, and find
    this rank's per-local-tile ranges.  Returns (s_feat [R, NFEAT], s_ok
    [R], tile_start [my_tiles], tile_count [my_tiles] int32, glob
    [my_tiles] int32): local tile t_loc is global tile t_loc * n_dev +
    dev_id."""
    dev = recs.device
    tile_g = torch.where(rec_ok, recs[:, -1].to(torch.int64), num_tiles)
    depth = torch.where(rec_ok, recs[:, 18],
                        torch.full_like(recs[:, 18], float("inf")))
    by_depth = torch.sort(depth, stable=True).indices
    perm = by_depth[torch.sort(tile_g[by_depth], stable=True).indices]
    s_tile = tile_g[perm]
    glob = torch.arange(my_tiles, device=dev) * n_dev + dev_id
    tile_start = torch.searchsorted(s_tile, glob)
    tile_end = torch.searchsorted(s_tile, glob + 1)
    return (recs.index_select(0, perm)[:, :NFEAT], rec_ok[perm],
            tile_start.to(torch.int32),
            (tile_end - tile_start).to(torch.int32), glob.to(torch.int32))


def slab_inputs(s_feat, s_ok, tile_start, tile_count, glob, grid_x: int,
                grid_y: int, cfg: RasterConfig) -> tuple:
    """K1's arguments for this rank's slab: the records arrive
    depth-sorted per local tile, so they are the sorted features (NFEAT
    columns, a record that is not valid at opacity 0) with the identity
    pair rank, each tile's count clamped at ``tile_cap`` (0 for a slab
    slot past the grid, when D does not divide the tile count), and the
    global-tile map ``glob`` for the pixels.  Returns (feats, pair_rank,
    tile_start, counts, grid_x, chunk, gtile)."""
    num_tiles = grid_x * grid_y
    counts = torch.where(glob < num_tiles,
                         torch.clamp_max(tile_count, cfg.tile_cap), 0)
    feats = torch.cat([s_feat[:, :17], torch.where(
        s_ok, s_feat[:, 17], 0.0)[:, None]], dim=-1).contiguous()
    rank = torch.arange(feats.shape[0], dtype=torch.int32,
                        device=feats.device)
    return (feats, rank, tile_start, counts.to(torch.int32), grid_x,
            cfg.chunk, glob)


def _blend_tiles_wq(s_feat, s_ok, tile_start, tile_count, glob, grid_x: int,
                    grid_y: int, cfg: RasterConfig):
    """This rank's slab blend (``slab_inputs``): K1 on CUDA tensors, K1 in
    training mode and K2 in the backward when a gradient is wanted, the
    plain blend with the same map on CPU tensors.  Returns (color
    [myT, P, 3], allmap [myT, P, 8]) with a zero background."""
    from ..ops.cuda.blend import BlendTiles, blend_fwd
    args = slab_inputs(s_feat, s_ok, tile_start, tile_count, glob, grid_x,
                       grid_y, cfg)
    train = (args[0].device.type == "cuda" and torch.is_grad_enabled()
             and args[0].requires_grad)
    state = BlendTiles.apply(*args) if train \
        else blend_fwd(*args[:6], gtile=glob)
    return state_to_maps(state)


def shard_render_core(cam: Camera, means, scl, qt, opc, col, alv,
                      grid_x: int, grid_y: int, n_dev: int,
                      cfg: RasterConfig, exchange_cap: int,
                      screen_probe=None, dev_id: int = 0, group=None):
    """The per-rank render body: this rank's Gaussians (``dev_id`` of
    ``n_dev`` in ``group``).  Returns (color_all [D, myT, P, 3],
    allmap_all [D, myT, P, 8], overflow (summed over the group), radii
    [n_local]); color and allmap are every rank's slabs, the same on
    every rank."""
    num_tiles = grid_x * grid_y
    my_tiles = -(-num_tiles // n_dev)
    prep = preprocess(means, scl, qt, cam)
    valid = prep.valid & alv
    prep = prep._replace(valid=valid,
                         radius=torch.where(valid, prep.radius, 0))
    Tmat = prep.T
    if screen_probe is not None:
        # the densify statistics' screen-gradient probe (render/renderer.py)
        probe = torch.zeros_like(Tmat)
        probe[:, 0, 2] = screen_probe[:, 0] * (
            Tmat[:, 2, 2] * (cam.W / 2.0)).detach()
        probe[:, 1, 2] = screen_probe[:, 1] * (
            Tmat[:, 2, 2] * (cam.H / 2.0)).detach()
        Tmat = Tmat + probe
    opc_m = torch.where(valid, opc, 0.0)
    n = means.shape[0]
    feats = torch.cat([Tmat.reshape(n, 9), prep.center, prep.normal, col,
                       opc_m[:, None], prep.depth[:, None]], dim=-1)

    blocks, blk_ok, overflow = _emit_records(
        prep, feats, grid_x, grid_y, n_dev, cfg, exchange_cap,
        opacity=opc_m)
    if group is None:
        recs, rec_ok = blocks, blk_ok
    else:
        recs = _Exchange.apply(blocks, group)
        rec_ok = _all_to_all(blk_ok.to(torch.int32), group).bool()
    s_feat, s_ok, tile_start, tile_count, glob = _sort_records(
        recs.reshape(-1, NFEAT + 1), rec_ok.reshape(-1), my_tiles,
        num_tiles, n_dev, dev_id)
    color, allmap = _blend_tiles_wq(s_feat, s_ok, tile_start, tile_count,
                                    glob, grid_x, grid_y, cfg)
    slab = torch.cat([color, allmap], dim=-1)            # [myT, P, 11]
    slabs = slab[None] if group is None else \
        _GatherSlabs.apply(slab, s_feat, group, n_dev, dev_id)
    return (slabs[..., :3], slabs[..., 3:], _psum(overflow, group),
            prep.radius)


def assemble_interleaved(color_all, allmap_all, bg, grid_x: int,
                         grid_y: int, H: int, W: int):
    """[D, myT, P, C] interleaved slabs -> composited [H, W, *] maps."""
    num_tiles = grid_x * grid_y

    def deinterleave(x):
        D, t_loc = x.shape[0], x.shape[1]
        return x.transpose(0, 1).reshape(D * t_loc, *x.shape[2:])[:num_tiles]

    tile_color = deinterleave(color_all)
    tile_allmap = deinterleave(allmap_all)
    tile_color = tile_color + (1.0 - tile_allmap[..., 1:2]) * bg
    return (tiles_to_image(tile_color, grid_x, grid_y, H, W),
            tiles_to_image(tile_allmap, grid_x, grid_y, H, W))


def render_gauss_sharded(group, cam: Camera, means3d, scales, quats,
                         opacity, colors, alive, bg,
                         cfg: RasterConfig = RasterConfig(),
                         exchange_cap: int = 4096,
                         screen_probe=None) -> ShardRender:
    """Render with this rank's Gaussians (a shard of dim 0, as
    ``shard_gaussians`` cuts it) and its interleaved tiles; ``group`` the
    ranks of the gauss axis (None: one process, D = 1).  Every rank gets
    the whole image."""
    n_dev = 1 if group is None else dist.get_world_size(group)
    dev_id = 0 if group is None else dist.get_rank(group)
    gx, gy = tile_grid(cam.H, cam.W)
    color_all, allmap_all, overflow, radii = shard_render_core(
        cam, means3d, scales, quats, opacity, colors, alive, gx, gy, n_dev,
        cfg, exchange_cap, screen_probe=screen_probe, dev_id=dev_id,
        group=group)
    image, allmap = assemble_interleaved(color_all, allmap_all, bg, gx, gy,
                                         cam.H, cam.W)
    return ShardRender(image=image, allmap=allmap, overflow=overflow,
                       radii=radii)


@torch.no_grad()
def measure_exchange_counts(group, cam: Camera, means3d, scales, quats,
                            alive, cfg: RasterConfig = RasterConfig(),
                            opacity=None, full: bool = False):
    """The largest per-(source, destination) record count of the exchange
    for this scene, from this rank's shard and every other's: the input
    that sizes ``exchange_cap``.  Pass ``opacity`` so the count reflects
    the visibility cull the render applies.  Returns an int, or with
    ``full`` the [src, dst] count matrix (numpy)."""
    n_dev = 1 if group is None else dist.get_world_size(group)
    gx, gy = tile_grid(cam.H, cam.W)
    if opacity is None:
        opacity = torch.ones_like(means3d[:, 0])
    prep = preprocess(means3d, scales, quats, cam)
    valid = prep.valid & alive
    prep = prep._replace(valid=valid,
                         radius=torch.where(valid, prep.radius, 0))
    counts = _emit_records(prep, None, gx, gy, n_dev, cfg, exchange_cap=0,
                           counts_only=True,
                           opacity=torch.where(valid, opacity, 0.0))
    mat = _gather_rows(counts, group, n_dev).cpu().numpy()
    return mat if full else int(mat.max())


def suggest_exchange_cap(group, cams, means3d, scales, quats, alive,
                         cfg: RasterConfig = RasterConfig(),
                         margin: float = 1.5, quantum: int = 256,
                         opacity=None) -> int:
    """Size the exchange from the measured per-destination counts over a
    sample of cameras, with headroom for growth during training."""
    mx = max(measure_exchange_counts(group, c, means3d, scales, quats,
                                     alive, cfg, opacity=opacity)
             for c in cams)
    return max(quantum, int(-(-mx * margin // quantum)) * quantum)


def shard_gaussians(n_dev: int, dev_id: int, tree):
    """This rank's shard of per-Gaussian arrays (dim 0 = N, cut in n_dev
    equal blocks): a tensor, or a list, tuple or dict of them."""
    def cut(x):
        n = x.shape[0]
        if n % n_dev:
            raise ValueError(f"{n} rows do not split over {n_dev} ranks "
                             f"(pad_to_multiple)")
        m = n // n_dev
        return x[dev_id * m:(dev_id + 1) * m]
    if isinstance(tree, dict):
        return {k: cut(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cut(v) for v in tree)
    return cut(tree)


def pad_to_multiple(arr: np.ndarray, m: int, fill=0.0):
    n = arr.shape[0]
    pad = (-n) % m
    if pad == 0:
        return arr
    pad_block = np.full((pad, *arr.shape[1:]), fill, arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)

