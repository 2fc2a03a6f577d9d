"""The dense blend route: ``build_gdata``, the wrappers of K3
(``csrc/blend_fwd.cu`` ``blend_dense_fwd_launch``) and K4
(``csrc/blend_bwd.cu`` ``blend_dense_bwd_launch``), ``BlendTilesDense``,
the autograd function that pairs them, and their plain PyTorch versions
(counterpart of d2dgs_tpu/ops/pallas/blend_tpu.py:842-884).

K3 replaces ``_fwd_kernel``: tile t blends rows [0, counts[t]) of its own
slab of the dense pair buffer gdata [T, tile_cap, NFEAT] into the state
rows [T, NSTATE, PIX] in K1's two passes.  K4 replaces ``_bwd_kernel``:
the gradient of those state rows in gdata, [T, tile_cap, NFEAT], zero
past counts[t], one work item per (tile, SEG-pair segment) as K2.  The sum
per Gaussian over its tiles is autograd's transpose of the gather in
``build_gdata``, as XLA's is in the JAX package.  K3/K4 share their device
code with K1/K2, so both routes make the same decisions bit for bit.
"""
from __future__ import annotations

import torch

from ..binning import Binning
from ..tiled_raster import NFEAT, PIX, blend_walk
from . import build
from .blend import (DEAD_ROWS, NREC, SEG, Segments, bwd_launch, forward_work,
                    fwd_launch, segment_layout)


def build_gdata(feats: torch.Tensor, binning: Binning, tile_cap: int):
    """Gather per-pair features into the dense [T, tile_cap, NFEAT] buffer
    (blend_tpu.py:842-860): row i of tile t is the tile's i-th pair in
    depth order, zero past the tile's count.  feats: [N, NFEAT] per
    Gaussian, original index space.  Returns (gdata, counts [T] int32 =
    min(tile_count, tile_cap)).  Differentiable in ``feats``: the gather's
    transpose sums each Gaussian's pair gradients over its tiles.

    The values are those of the JAX package's masked [T, tile_cap] gather;
    here the kept pairs are written into a zero buffer instead, so the
    transpose reads back only those rows (the masked gather's transpose
    would sum T * tile_cap rows, nearly all of them zero into one row).
    The output stays connected to ``feats`` when no pair is binned."""
    dev = feats.device
    num_tiles = binning.tile_count.shape[0]
    count = binning.tile_count.long()
    # (tile, position in the tile) of every binned pair, tile by tile
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev),
                                      count)
    local = (torch.arange(tile_of.shape[0], device=dev)
             - (torch.cumsum(count, 0) - count)[tile_of])
    keep = local < tile_cap
    tile_of, local = tile_of[keep], local[keep]
    dst = tile_of * tile_cap + local
    src = binning.tile_start.long()[tile_of] + local
    gid = binning.order.long()[binning.pair_rank.long()[src]]
    g = feats.new_zeros((num_tiles * tile_cap, NFEAT)).index_put(
        (dst,), feats[gid])
    counts = torch.clamp_max(binning.tile_count, tile_cap).to(torch.int32)
    return g.view(num_tiles, tile_cap, NFEAT), counts


def blend_dense_plain(gdata: torch.Tensor, counts: torch.Tensor, grid_x: int,
                      chunk: int = 64,
                      tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K3: blend rows [0, counts[t]) of each tile's slab
    of gdata [T, cap, NFEAT], ``chunk`` rows at a time.  ``tile_ids``
    (optional) gives the grid index of each of the T tiles when they are a
    subset of the grid.  Returns the state rows [T, NSTATE, PIX]."""
    dev = gdata.device
    cap = gdata.shape[1]
    if tile_ids is None:
        tile_ids = torch.arange(gdata.shape[0], device=dev)
    lane = torch.arange(chunk, device=dev)

    def chunk_rows(c0):
        return gdata[:, torch.clamp_max(c0 + lane, cap - 1)]
    return blend_walk(chunk_rows, counts, grid_x, chunk, tile_ids)


def blend_dense_plain_vjp(gdata: torch.Tensor, counts: torch.Tensor,
                          grid_x: int, g_state: torch.Tensor,
                          tiles: torch.Tensor | None = None,
                          chunk: int = 64) -> torch.Tensor:
    """Plain version of K4: the gradient of <state, g_state> in gdata
    [T, cap, NFEAT], by autograd through ``blend_dense_plain``.  The
    cotangents of ``DEAD_ROWS`` are taken as zero, as K4 does.  ``tiles``
    (optional, int64 tile indices) restricts the blend to those tiles, at
    their true pixel coordinates; the other tiles' rows are zero."""
    g = g_state.clone()
    g[:, list(DEAD_ROWS)] = 0.0
    sub, cnt = gdata, counts
    if tiles is not None:
        sub, cnt, g = gdata[tiles], counts[tiles], g[tiles]
    with torch.enable_grad():
        f = sub.detach().requires_grad_()
        state = blend_dense_plain(f, cnt, grid_x, chunk=chunk, tile_ids=tiles)
        if not state.requires_grad:       # no pairs in these tiles
            d = torch.zeros_like(f)
        else:
            d, = torch.autograd.grad(state, f, g)
    if tiles is None:
        return d
    out = torch.zeros_like(gdata)
    out[tiles] = d
    return out


def _check_dense(gdata, counts, grid_x):
    """Device, type and shape checks shared by K3 and K4; returns
    (tiles, tile_cap)."""
    dev = gdata.device
    build.expect("gdata", gdata, torch.float32, (None, None, NFEAT), dev)
    build.expect("counts", counts, torch.int32, 1, dev)
    num_tiles, cap, _ = gdata.shape
    if counts.shape[0] != num_tiles or grid_x <= 0 \
            or num_tiles % grid_x != 0:
        raise ValueError(f"gdata {tuple(gdata.shape)} and counts "
                         f"{tuple(counts.shape)} do not form a grid "
                         f"{grid_x} tiles wide")
    return num_tiles, cap


def blend_dense_fwd(gdata: torch.Tensor, counts: torch.Tensor, grid_x: int,
                    chunk: int = 64, records: torch.Tensor | None = None,
                    segments: Segments | None = None, *, max_pairs: int,
                    n_pass_a: torch.Tensor | None = None,
                    unit_ns: torch.Tensor | None = None,
                    item_ns: torch.Tensor | None = None,
                    report: dict | None = None) -> torch.Tensor:
    """Blend every tile's slab: gdata [T, cap, NFEAT] float32, counts [T]
    int32 (each at most cap) -> state rows [T, NSTATE, PIX] float32.

    Training mode (``records`` [T, NREC, PIX] int32 and ``segments``,
    ``segment_layout(counts)``): K3 also writes K4's records and
    checkpoints, as K1 for K2.  On CPU tensors this is
    ``blend_dense_plain`` and ``records`` and ``segments`` are left as
    they are; on CUDA tensors it launches K3 (K1's two passes) or raises.
    The work is sized from ``max_pairs``, a bound on counts.sum() known on
    the host (the binning's pair count, ``binning.pair_rank.shape[0]``),
    and nothing is read back.  ``n_pass_a``, ``unit_ns``, ``item_ns`` and
    ``report`` as for ``blend_fwd``."""
    if gdata.device.type == "cpu":
        return blend_dense_plain(gdata, counts, grid_x, chunk=chunk)
    dev = gdata.device
    if dev.type != "cuda":
        raise ValueError(f"blend_dense_fwd runs on cpu or cuda, not {dev}")
    num_tiles, cap = _check_dense(gdata, counts, grid_x)
    state = fwd_launch(
        "blend_dense_fwd_launch", (gdata, counts, cap, num_tiles, grid_x),
        num_tiles, forward_work(num_tiles, max_pairs, segments,
                                max_segs=-(-cap // SEG)),
        records, segments, n_pass_a, unit_ns, item_ns, report, dev)
    blend_dense_fwd.launches += 1
    return state


blend_dense_fwd.launches = 0


def blend_dense_bwd(gdata: torch.Tensor, counts: torch.Tensor, grid_x: int,
                    state: torch.Tensor, records: torch.Tensor,
                    g_state: torch.Tensor, segments: Segments | None = None,
                    chunk: int = 64, n_reduce: torch.Tensor | None = None,
                    item_ns: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the dense blend in gdata: K3's inputs, its ``state``,
    ``records`` and ``segments`` (training mode), and the cotangent
    ``g_state`` [T, NSTATE, PIX] -> d_gdata [T, cap, NFEAT] float32, zero
    past counts[t].

    On CPU tensors this is ``blend_dense_plain_vjp`` (``state``,
    ``records`` and ``segments`` unused); on CUDA tensors it launches K4,
    one CTA per work item, or raises.  ``n_reduce`` and ``item_ns`` as
    for ``blend_bwd``."""
    if gdata.device.type == "cpu":
        return blend_dense_plain_vjp(gdata, counts, grid_x, g_state,
                                     chunk=chunk)
    dev = gdata.device
    if dev.type != "cuda":
        raise ValueError(f"blend_dense_bwd runs on cpu or cuda, not {dev}")
    num_tiles, cap = _check_dense(gdata, counts, grid_x)
    d_gdata = bwd_launch("blend_dense_bwd_launch", (gdata, cap), (grid_x,),
                         num_tiles, state, records, g_state, segments,
                         n_reduce, item_ns, dev)
    blend_dense_bwd.launches += 1
    return d_gdata


blend_dense_bwd.launches = 0


class BlendTilesDense(torch.autograd.Function):
    """State rows of the dense blend, differentiable in gdata: forward K3
    in training mode, backward K4.  ``build_gdata``'s gather stays
    outside, so autograd sums the per-pair gradients per Gaussian.
    ``max_pairs`` as for ``blend_dense_fwd``."""

    @staticmethod
    def forward(ctx, gdata, counts, grid_x, max_pairs, chunk=64):
        records = torch.empty((gdata.shape[0], NREC, PIX), dtype=torch.int32,
                              device=gdata.device)
        segments = segment_layout(counts)
        state = blend_dense_fwd(gdata, counts, grid_x, chunk=chunk,
                                records=records, segments=segments,
                                max_pairs=max_pairs)
        ctx.save_for_backward(gdata, counts, state, records,
                              *segments.tensors)
        ctx.grid_x, ctx.chunk = grid_x, chunk
        return state

    @staticmethod
    def backward(ctx, g_state):
        gdata, counts, state, records, *segments = ctx.saved_tensors
        d_gdata = blend_dense_bwd(gdata, counts, ctx.grid_x, state, records,
                                  g_state.contiguous(), Segments(*segments),
                                  chunk=ctx.chunk)
        return d_gdata, None, None, None, None
