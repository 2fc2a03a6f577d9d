"""Wrappers of the 3DGS flow blend kernels ``csrc/raster3d.cu``: K5
(``blend3d_fwd``, the forward) and K6 (``blend3d_bwd``, its VJP), and
``Blend3D``, the autograd function that pairs them.

They replace the blend of the JAX package's ``rasterize_3dgs``
(d2dgs_tpu/ops/raster3d.py:140-225, a ``lax.scan`` that XLA compiles; no
Pallas kernel).  K5 runs in two passes, as K1 does: each 64-pair unit's
transmittance products and kept pairs, then one work item per (tile,
256-pair segment) walking its kept pairs from the product of its tile's
earlier units, folded per tile; K6 runs one work item per (tile,
segment) from K5's checkpoints.  The plain PyTorch version is
``ops/raster3d.blend3d_plain``; on CPU tensors the wrappers use it (K6's
through autograd), on CUDA tensors they launch the kernel or raise.
``blend3d_segments_plain`` and ``blend3d_bwd_segments_plain`` emulate
the kernels' algorithm, ``warp_refuses_plain`` their per-warp cull, and
``compare_blend3d`` judges K5's state against the plain walk's.  The
kernels are built for C = 3 colour channels (the flow path's) only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...config import ALPHA_CLIP, ALPHA_CUTOFF, T_CUTOFF
from ..raster3d import (DEC3_BLEND, DEC3_EVAL, DEC3_T, alpha3d,
                        blend3d_plain)
from ..tiled_raster import PIX, _tile_pixels
from . import build
from .blend import (BAND_ULPS, SEG, ULP_CUTOFF, UNIT, _check, _ptr,
                    forward_work, layout_len)

SOURCE = "raster3d.cu"
CHANNELS = 3          # the colour channels the kernels are built for
# the kernels' scratch rows per pixel: pass A's per item (each unit's
# product, then SEG / 32 words of kept-pair bits), a multi-segment item's
# partial state, a checkpoint (T, the colour sums, the depth sum); and the
# floats of a packed Gaussian row
NCAND = SEG // UNIT + SEG // 32
NPART = 7
NCK = 5
NROW = 12
# the cull's margin in the power (csrc/raster3d.cu ``cull_power``)
CULL_MARGIN = 1e-3
# K5 against the plain walk, and the flow image on the card against the
# CPU's: T and the colour sums (the image and alpha), the depth sum
# (tests/test_torch_raster3d.py's tolerances)
IMG_TOL, DEPTH_TOL = 2e-5, 2e-4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raster3d_fwd_launch.argtypes = [p] * 8 + [i] * 7 + [p] * 12 + [
        i, p, i, p]
    lib.raster3d_fwd_launch.restype = i
    lib.raster3d_bwd_launch.argtypes = [p] * 3 + [i] * 4 + [p] * 16 + [
        i, p]
    lib.raster3d_bwd_launch.restype = i
    lib.raster3d_error_string.argtypes = [i]
    lib.raster3d_error_string.restype = ctypes.c_char_p
    return lib


def walk_cap(chunk: int, tile_cap: int) -> int:
    """The most pairs of a tile the blend walks: floor(tile_cap / chunk)
    chunks of ``chunk`` pairs, at least one, as the JAX scan."""
    return max(tile_cap // chunk, 1) * chunk


class Walk3D(NamedTuple):
    """What K5 writes in training mode for K6: each pixel's pairs up to
    its last blended one (``n_walk`` [T, PIX] int32), the work lists K5
    laid out on the card (``layout``, int32), each pixel's T, colour
    sums and depth sum at every SEG-th pair of its tile (``ckpt``
    [B // SEG, NCK, PIX] float32; tile t's from row item_start[t] - t)
    and the packed Gaussian rows (``rows`` [N, NROW] float32).
    ``grid_items`` is the bound both kernels' grids take.  Every size
    comes from the pair count B and the Gaussian count N on the host
    (``walk_buffers``)."""
    n_walk: torch.Tensor
    layout: torch.Tensor
    ckpt: torch.Tensor
    rows: torch.Tensor
    grid_items: int


def walk_buffers(num_tiles: int, n_pairs: int, n_gauss: int,
                 device) -> Walk3D:
    """Unwritten training-mode buffers of K5 for ``num_tiles`` tiles,
    ``n_pairs`` pairs (``pair_gid.numel()``) and ``n_gauss`` Gaussians: a
    tile of c pairs has ceil(c / SEG) - 1 <= c // SEG checkpoints, so
    n_pairs // SEG rows hold every tile's, with no read of the counts."""
    n_items, _, n_units = forward_work(num_tiles, n_pairs)
    return Walk3D(
        torch.empty((num_tiles, PIX), dtype=torch.int32, device=device),
        torch.empty(layout_len(num_tiles, n_items, n_units),
                    dtype=torch.int32, device=device),
        torch.empty((n_pairs // SEG, NCK, PIX), dtype=torch.float32,
                    device=device),
        torch.empty((n_gauss, NROW), dtype=torch.float32, device=device),
        n_items)


def check_inputs(conic, center, colors, depth, opac, pair_gid, tile_start,
                 tile_count):
    """Device, type and shape checks of the kernels' inputs (each on
    conic's device, contiguous; float32 [N,3], [N,2], [N,C], [N], [N];
    int32 [B], [T], [T]; C = CHANNELS); returns (N, C) or raises."""
    dev = conic.device
    for name, t, ndim in (("conic", conic, 2), ("center", center, 2),
                          ("colors", colors, 2), ("depth", depth, 1),
                          ("opac", opac, 1)):
        _check(name, t, torch.float32, ndim, dev)
    for name, t in (("pair_gid", pair_gid), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        _check(name, t, torch.int32, 1, dev)
    n, c = colors.shape
    if conic.shape != (n, 3) or center.shape != (n, 2) \
            or depth.shape != (n,) or opac.shape != (n,):
        raise ValueError(
            f"conic {tuple(conic.shape)}, center {tuple(center.shape)}, "
            f"depth {tuple(depth.shape)}, opac {tuple(opac.shape)} do not "
            f"fit colors {tuple(colors.shape)}: expected [N,3], [N,2], [N], "
            f"[N]")
    if c != CHANNELS:
        raise ValueError(f"colors has {c} channels; the 3DGS blend kernels "
                         f"are built for {CHANNELS}")
    if tile_count.shape != tile_start.shape:
        raise ValueError(f"tile_start {tuple(tile_start.shape)} and "
                         f"tile_count {tuple(tile_count.shape)} differ")
    return n, c


def _check_shape(name, t, dtype, shape, dev):
    _check(name, t, dtype, len(shape), dev)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_walk(walk: Walk3D, num_tiles: int, n_pairs: int, n_gauss: int,
                dev):
    n_items, _, n_units = forward_work(num_tiles, n_pairs)
    if walk.grid_items != n_items:
        raise ValueError(f"walk was laid out for {walk.grid_items} items; "
                         f"these inputs take {n_items} (walk_buffers)")
    _check_shape("n_walk", walk.n_walk, torch.int32, (num_tiles, PIX), dev)
    _check_shape("layout", walk.layout, torch.int32,
                 (layout_len(num_tiles, n_items, n_units),), dev)
    _check_shape("ckpt", walk.ckpt, torch.float32,
                 (n_pairs // SEG, NCK, PIX), dev)
    _check_shape("rows", walk.rows, torch.float32, (n_gauss, NROW), dev)


def _check_timers(dev, **timers):
    for name, t in timers.items():
        if t is not None:
            _check(name, t, torch.int64, 2, dev)
            if t.shape[1] != 2:
                raise ValueError(f"{name} must be [n, 2], got "
                                 f"{tuple(t.shape)}")


def _raise(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().raster3d_error_string(err).decode())


def blend3d_fwd(conic, center, colors, depth, opac, pair_gid, tile_start,
                tile_count, grid_x: int, chunk: int = 64,
                tile_cap: int = 4096, walk: Walk3D | None = None,
                work: torch.Tensor | None = None,
                stats: torch.Tensor | None = None,
                unit_ns: torch.Tensor | None = None,
                item_ns: torch.Tensor | None = None,
                report: dict | None = None):
    """The tile state (T [T, PIX], colour sums [T, PIX, C], depth sums
    [T, PIX]) of the blend of each tile's pairs (``blend3d_plain``'s
    arguments).  On CPU tensors this is ``blend3d_plain`` (the optional
    arguments unused); on CUDA tensors it launches K5 or raises: the
    packing of the Gaussian rows, the layout kernel, a first pass of one
    CTA per 64 pairs of a tile, then one CTA per (tile, 256-pair
    segment).  The grids and scratch are sized from the pair count B and
    nothing is read back.

    ``walk`` (``walk_buffers``, training mode) receives K6's inputs: each
    pixel's pairs up to its last blended one, the work lists, the
    checkpoints and the packed rows.  Optional: ``work`` (int32 [T, 2, PIX]) each pixel's
    evaluated and blended pair counts as a sequential walk counts them;
    ``stats`` (int64 [3]) is incremented by the first pass's pair-pixel
    evaluations, its (pair, warp) tests and the tests that refused;
    ``unit_ns`` [U, 2] and ``item_ns`` [I, 2] (int64) receive the
    %globaltimer stamps at the start and end of units 0..U-1 and of work
    items 0..I-1; ``report`` (dict) receives the grids, each scratch
    buffer's bytes and the layout buffer (``forward_layout`` of
    ops/cuda/blend.py reads it)."""
    dev = conic.device
    if dev.type == "cpu":
        return blend3d_plain(conic, center, colors, depth, opac, pair_gid,
                             tile_start, tile_count, grid_x, chunk, tile_cap)
    if dev.type != "cuda":
        raise ValueError(f"blend3d_fwd runs on cpu or cuda, not {dev}")
    n, c = check_inputs(conic, center, colors, depth, opac, pair_gid,
                        tile_start, tile_count)
    num_tiles, n_pairs = tile_start.shape[0], pair_gid.shape[0]
    n_items, n_slots, n_units = forward_work(num_tiles, n_pairs)
    if walk is not None:
        _check_walk(walk, num_tiles, n_pairs, n, dev)
        layout, rows = walk.layout, walk.rows
    else:
        layout = torch.empty(layout_len(num_tiles, n_items, n_units),
                             dtype=torch.int32, device=dev)
        rows = torch.empty((n, NROW), dtype=torch.float32, device=dev)
    if work is not None:
        _check_shape("work", work, torch.int32, (num_tiles, 2, PIX), dev)
    if stats is not None:
        _check_shape("stats", stats, torch.int64, (3,), dev)
    _check_timers(dev, unit_ns=unit_ns, item_ns=item_ns)
    T = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    C = torch.empty((num_tiles, PIX, c), dtype=torch.float32, device=dev)
    D = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    cand = torch.empty((n_items, NCAND, PIX), dtype=torch.float32,
                       device=dev)
    part = torch.empty((n_slots, NPART, PIX), dtype=torch.float32,
                       device=dev)
    timed = lambda t: 0 if t is None else t.shape[0]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster3d_fwd_launch(
            conic.data_ptr(), center.data_ptr(), colors.data_ptr(),
            depth.data_ptr(), opac.data_ptr(), pair_gid.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, grid_x,
            walk_cap(chunk, tile_cap), c, n, n_items, n_units,
            rows.data_ptr(), layout.data_ptr(), cand.data_ptr(),
            part.data_ptr(), T.data_ptr(), C.data_ptr(), D.data_ptr(),
            _ptr(walk and walk.n_walk), _ptr(walk and walk.ckpt),
            _ptr(work), _ptr(stats), _ptr(unit_ns), timed(unit_ns),
            _ptr(item_ns), timed(item_ns), stream)
    _raise(err, "blend3d_fwd")
    blend3d_fwd.launches += 1
    if report is not None:
        report.update(
            num_tiles=num_tiles, grid_items=n_items, grid_units=n_units,
            layout=layout, scratch_bytes={
                k: t.numel() * t.element_size() for k, t in (
                    ("rows", rows), ("layout", layout), ("first_pass", cand),
                    ("partials", part),
                    ("checkpoints", walk.ckpt if walk else rows[:0]))})
    return T, C, D


blend3d_fwd.launches = 0


def blend3d_plain_vjp(conic, center, colors, depth, opac, pair_gid,
                      tile_start, tile_count, grid_x: int, gT, gC, gD,
                      chunk: int = 64, tile_cap: int = 4096):
    """Plain version of K6: the gradients of <(T, C, D), (gT, gC, gD)> in
    (conic, center, colors, depth, opac), by autograd through
    ``blend3d_plain``.  A view with no pair has zero gradients."""
    xs = [t.detach().requires_grad_() for t in (conic, center, colors, depth,
                                                 opac)]
    with torch.enable_grad():
        out = blend3d_plain(*xs, pair_gid, tile_start, tile_count, grid_x,
                            chunk, tile_cap)
        return torch.autograd.grad(out, xs, (gT, gC, gD))


def blend3d_bwd(conic, center, colors, depth, opac, pair_gid, tile_start,
                tile_count, grid_x: int, state, walk, gT, gC, gD,
                chunk: int = 64, tile_cap: int = 4096,
                stats: torch.Tensor | None = None,
                item_ns: torch.Tensor | None = None):
    """The gradients (d_conic, d_center, d_colors, d_depth, d_opac) of the
    blend for the cotangents gT [T, PIX], gC [T, PIX, C], gD [T, PIX] of
    its outputs, from K5's final ``state`` (T, C, D) and its training-mode
    ``walk`` (``Walk3D``).  On CPU tensors this is ``blend3d_plain_vjp``
    (``state`` and ``walk`` unused); on CUDA tensors it launches K6, one
    CTA per work item of ``walk``'s lists, or raises.  K6 reads the
    Gaussians' features from the rows K5 packed into ``walk``, so conic,
    center, colors, depth and opac must be the ones K5 blended; here only
    their shapes are read.  ``stats`` (optional
    int64 [2]) is incremented by its (pair, warp) cull tests and the tests
    that refused; ``item_ns`` (optional int64 [I, 2]) receives each work
    item's %globaltimer stamps at its start and end."""
    dev = conic.device
    if dev.type == "cpu":
        return blend3d_plain_vjp(conic, center, colors, depth, opac,
                                 pair_gid, tile_start, tile_count, grid_x,
                                 gT, gC, gD, chunk, tile_cap)
    if dev.type != "cuda":
        raise ValueError(f"blend3d_bwd runs on cpu or cuda, not {dev}")
    n, c = check_inputs(conic, center, colors, depth, opac, pair_gid,
                        tile_start, tile_count)
    num_tiles = tile_start.shape[0]
    T, C, D = state
    for name, t, shape in (("T", T, (num_tiles, PIX)),
                           ("C", C, (num_tiles, PIX, c)),
                           ("D", D, (num_tiles, PIX)),
                           ("gT", gT, (num_tiles, PIX)),
                           ("gC", gC, (num_tiles, PIX, c)),
                           ("gD", gD, (num_tiles, PIX))):
        _check_shape(name, t, torch.float32, shape, dev)
    _check_walk(walk, num_tiles, pair_gid.shape[0], n, dev)
    if stats is not None:
        _check_shape("stats", stats, torch.int64, (2,), dev)
    _check_timers(dev, item_ns=item_ns)
    grads = [torch.zeros_like(t) for t in (conic, center, colors, depth,
                                           opac)]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster3d_bwd_launch(
            walk.rows.data_ptr(), pair_gid.data_ptr(),
            tile_start.data_ptr(), num_tiles, grid_x, c, walk.grid_items,
            walk.layout.data_ptr(), walk.ckpt.data_ptr(),
            T.data_ptr(), C.data_ptr(), D.data_ptr(),
            walk.n_walk.data_ptr(), gT.data_ptr(), gC.data_ptr(),
            gD.data_ptr(), *(g.data_ptr() for g in grads), _ptr(stats),
            _ptr(item_ns), 0 if item_ns is None else item_ns.shape[0],
            stream)
    _raise(err, "blend3d_bwd")
    blend3d_bwd.launches += 1
    return tuple(grads)


blend3d_bwd.launches = 0


class Blend3D(torch.autograd.Function):
    """The tile state (T, colour sums, depth sums) of the 3DGS blend,
    differentiable in conic, center, colors, depth and opac: forward
    ``blend3d_fwd`` (in training mode on the card), backward
    ``blend3d_bwd`` (K5 and K6 on CUDA tensors, whose gathers through
    ``pair_gid`` and sums of each Gaussian's gradient over its pairs
    happen in the kernels; the plain walk and its autograd VJP on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, conic, center, colors, depth, opac, pair_gid,
                tile_start, tile_count, grid_x, chunk=64, tile_cap=4096):
        walk = walk_buffers(tile_start.shape[0], pair_gid.shape[0],
                            conic.shape[0], conic.device) \
            if conic.is_cuda else None
        T, C, D = blend3d_fwd(conic, center, colors, depth, opac, pair_gid,
                              tile_start, tile_count, grid_x, chunk,
                              tile_cap, walk=walk)
        ctx.save_for_backward(conic, center, colors, depth, opac, pair_gid,
                              tile_start, tile_count, T, C, D,
                              *(walk[:4] if walk else ()))
        ctx.grid_x, ctx.chunk, ctx.tile_cap = grid_x, chunk, tile_cap
        ctx.grid_items = walk.grid_items if walk else 0
        return T, C, D

    @staticmethod
    def backward(ctx, gT, gC, gD):
        saved = ctx.saved_tensors
        walk = Walk3D(*saved[11:], ctx.grid_items) if saved[11:] else None
        grads = blend3d_bwd(*saved[:8], ctx.grid_x, saved[8:11], walk,
                            gT.contiguous(), gC.contiguous(),
                            gD.contiguous(), chunk=ctx.chunk,
                            tile_cap=ctx.tile_cap)
        return (*grads, None, None, None, None, None, None)


# ----------------------------------------------------------------------
# The kernels' algorithm on the CPU, and the judgement of K5's state


def compare_blend3d(out, work, plain, dec, tile_pairs, seg: int = SEG,
                    single_tol: float = 0.0) -> dict:
    """K5's tile state ``out`` (T, colour sums, depth sums) and ``work``
    rows [T, 2, PIX] against the plain walk's ``plain`` state and
    ``dec`` decisions (``blend3d_plain(decisions=True)``); ``tile_pairs``
    [T] the pairs each tile walked (min(tile_count, cap)).

    A pixel flips when the two walks blended different numbers of pairs.
    K5 composes T entering a segment unit by unit, so on a tile of more
    than ``seg`` pairs its T differs from the plain walk's by a few ulp,
    and where that T lies within those ulps of T_CUTOFF the pixel blends
    one pair more or less.  Both walks multiply the same float32 factors
    (1 - alpha) (the same alphas: -fmad=false and expf, csrc/raster3d.cu)
    and differ only in how they associate them; a product of n factors in
    any association lies within (1 + u)^n - 1 ~ n u of the exact one (u =
    2^-24), so the two T after n blended pairs differ by at most 2 n u T,
    which at T_CUTOFF = 1e-4 (ulp 2^-37) is 1.64 n ulp.  A flip is in the
    band when it is of one pair and the plain T at the decision (its final
    T where K5 blended one more, its T before its last blended pair where
    K5 blended one fewer) lies within BAND_ULPS = 2 ulps of T_CUTOFF per
    factor in it.

    ``ok`` holds when every flip is in the band, every other pixel agrees
    within IMG_TOL (T, colours) and DEPTH_TOL (depth) and counts
    the same evaluated and blended pairs, every value is finite, and T is
    bitwise the plain walk's on every tile of at most ``seg`` pairs (which
    starts each pixel from 1 and multiplies in the plain walk's order; on
    the CPU, whose ``torch.cumprod`` multiplies float32 in float64, the
    CPU tests allow ``single_tol``).
    Returns ``ok``, the errors outside the flips, the flip counts, the
    band's furthest reach and the flip mask [T, PIX]."""
    Tk, Ck, Dk = (t.detach() for t in out)
    Tp, Cp, Dp = (t.detach() for t in plain)
    n_k = work[:, 1].to(torch.float64)
    n_p = dec[:, DEC3_BLEND].to(torch.float64)
    extra = n_k - n_p
    flip = extra != 0
    more = extra > 0
    t_dec = torch.where(more, Tp.to(torch.float64),
                        dec[:, DEC3_T].to(torch.float64))
    pairs = torch.where(more, n_p, n_p - 1.0)
    ulps = (t_dec - T_CUTOFF).abs() / ULP_CUTOFF
    share = ulps / (BAND_ULPS * pairs.clamp_min(1.0))
    in_band = flip & (extra.abs() == 1.0) & (share <= 1.0)   # NaN is out
    keep = ~flip
    err = {}
    for name, k, p in (("T", Tk, Tp), ("colour", Ck, Cp), ("depth", Dk, Dp)):
        e = (k - p).abs()
        if e.dim() == 3:
            e = e.amax(dim=-1)
        err[name] = float(e[keep].max()) if bool(keep.any()) else 0.0
    counts_differ = keep & ((work[:, 0].to(dec.dtype) != dec[:, DEC3_EVAL])
                            | (work[:, 1].to(dec.dtype) != n_p.to(dec.dtype)))
    single = tile_pairs <= seg
    single_err = float((Tk[single] - Tp[single]).abs().max()) \
        if bool(single.any()) else 0.0
    finite = all(bool(torch.isfinite(t).all()) for t in (Tk, Ck, Dk))
    worst = torch.where(flip, torch.nan_to_num(share, nan=float("inf")),
                        -1.0).flatten()
    at = int(torch.argmax(worst)) if bool(flip.any()) else None
    pick = lambda x: 0.0 if at is None else float(x.flatten()[at])
    res = {"max_abs_err": err, "flipped": int(flip.sum()),
           "in_band": int(in_band.sum()),
           "outside_band": int((flip & ~in_band).sum()),
           "band_max_share": pick(worst), "band_max_ulps": pick(ulps),
           "band_max_pairs": pick(pairs),
           "counts_differ": int(counts_differ.sum()),
           "single_segment_T_err": single_err,
           "multi_segment_tiles": int((~single).sum()),
           "pixels": flip.numel(), "finite": finite, "flip_mask": flip}
    res["ok"] = (finite and res["outside_band"] == 0
                 and res["counts_differ"] == 0 and single_err <= single_tol
                 and err["T"] <= IMG_TOL and err["colour"] <= IMG_TOL
                 and err["depth"] <= DEPTH_TOL)
    return res


def _tile_pairs(conic, center, colors, depth, opac, pair_gid, tile_start,
                counts, grid_x, length):
    """Each tile's first ``length`` pairs, zero past its count: the
    Gaussian ids [T, L], conics [T, L, 3], centres [T, L, 2], colour and
    depth rows [T, L, C + 1], opacities [T, L] and the pixels [T, PIX, 2]
    (corner samples)."""
    dev = conic.device
    num_tiles = tile_start.shape[0]
    lane = torch.arange(length, device=dev)
    valid = lane[None] < counts[:, None]
    if pair_gid.numel():
        idx = torch.clamp(tile_start.long()[:, None] + lane[None], 0,
                          pair_gid.numel() - 1)
        gid = torch.where(valid, pair_gid.long()[idx], 0)
    else:
        gid = torch.zeros((num_tiles, length), dtype=torch.long, device=dev)
    col = torch.cat([colors[gid], depth[gid][..., None]], dim=-1)
    op = torch.where(valid, opac[gid], 0.0)
    pix = _tile_pixels(grid_x, torch.arange(num_tiles, device=dev)) - 0.5
    return gid, conic[gid], center[gid], col, op, pix


def blend3d_segments_plain(conic, center, colors, depth, opac, pair_gid,
                           tile_start, tile_count, grid_x: int,
                           chunk: int = 64, tile_cap: int = 4096,
                           seg: int = SEG, t_of=None):
    """Plain emulation of K5's algorithm at segment length ``seg``
    (``blend3d_plain``'s arguments).  Returns ((T, C, D), n_walk [T, PIX]
    int32, work [T, 2, PIX] int32, ckpt [T, S - 1, NCK, PIX]): the tile
    state, each pixel's pairs up to its last blended one, its evaluated
    and blended pair counts, and its T, colour and depth sums after pairs
    [0, (s + 1) seg) (S the most segments of a tile; a tile's rows past its
    own segments repeat its final state).

    Pass A takes each min(UNIT, seg)-pair unit's product of (1 - alpha)
    (in order, over every pair: an unkept pair's factor is 1); pass B
    walks every segment of every tile at once from T_in, the ordered
    product of its tile's earlier units' products, with the kernel's
    arithmetic (T absolute; a pixel whose T_in is at or below T_CUTOFF
    walks nothing); the fold adds each tile's segments in order, stops at
    the first that reports done, and walks a segment entered at or below
    the cutoff without a trip on from its running T.  ``t_of`` (optional)
    maps pass A's incoming T [T, S, PIX] to the T the walks start from,
    to test the fold's decisions.  The
    warp's early stop of pass A (which only lowers a product already at
    or below the cutoff) is not emulated.  For the CPU tests of the
    algorithm; the kernels walk SEG only."""
    dev = conic.device
    num_tiles = tile_start.shape[0]
    counts = torch.clamp(tile_count.long(), max=walk_cap(chunk, tile_cap))
    n_own = torch.clamp_min((counts + seg - 1) // seg, 1)          # [T]
    n_seg = int(n_own.max()) if num_tiles else 1
    gid, con, cen, col, op, pix = _tile_pairs(
        conic, center, colors, depth, opac, pair_gid, tile_start, counts,
        grid_x, n_seg * seg)
    alpha = alpha3d(pix[:, None] - cen[:, :, None], con, op)  # [T, L, P]
    a_seg = alpha.view(num_tiles, n_seg, seg, PIX)
    c_seg = col.view(num_tiles, n_seg, seg, -1)
    nb = torch.clamp(counts[:, None]
                     - torch.arange(n_seg, device=dev) * seg, 0, seg)

    # pass A: the units' products and T entering each segment
    # (float32 products in order, as the kernel multiplies: the CPU's
    # torch.cumprod multiplies in float64)
    unit = min(UNIT, seg)
    fac = (1.0 - alpha).view(num_tiles, -1, unit, PIX)
    prods = torch.ones_like(fac[:, :, 0])                    # [T, U, P]
    for i in range(unit):
        prods = prods * fac[:, :, i]
    lead = [torch.ones_like(prods[:, 0])]
    for q in range((n_seg - 1) * (seg // unit)):
        lead.append(lead[-1] * prods[:, q])
    t_in = torch.stack(lead[::seg // unit], dim=1)
    if t_of is not None:
        t_in = t_of(t_in)
    pre = ~(t_in > T_CUTOFF)

    # pass B: every segment's walk from its T_in
    T = t_in.clone()
    acc = torch.zeros((*T.shape, col.shape[-1]), device=dev)
    n_blend = torch.zeros_like(T, dtype=torch.long)
    last = torch.full_like(n_blend, -1)
    trip = torch.full_like(n_blend, -1)
    for j in range(seg):
        a = a_seg[:, :, j]
        blend = (T > T_CUTOFF) & (a > 0.0)
        acc = torch.where(blend[..., None], acc + (a * T)[..., None]
                          * c_seg[:, :, j, None, :], acc)
        T = torch.where(blend, T * (1.0 - a), T)
        last = torch.where(blend, j, last)
        n_blend += blend
        trip = torch.where(blend & ~(T > T_CUTOFF), j, trip)
    done = trip >= 0
    n_eval = torch.where(pre, 0, torch.where(done, trip + 1, nb[..., None]))

    # the fold, segment by segment
    rT = torch.ones((num_tiles, PIX), device=dev)
    racc = torch.zeros((num_tiles, PIX, col.shape[-1]), device=dev)
    rdone = torch.zeros_like(rT, dtype=torch.bool)
    rn_eval = torch.zeros_like(rT, dtype=torch.long)
    rn_blend = torch.zeros_like(rn_eval)
    rlast = torch.full_like(rn_eval, -1)
    ckpt = []
    for s in range(n_seg):
        active = ~rdone & (s < n_own)[:, None]
        walked = active & ~pre[:, s]
        racc = torch.where(walked[..., None], racc + acc[:, s], racc)
        rT = torch.where(walked, T[:, s], rT)
        rn_eval += torch.where(walked, n_eval[:, s], 0)
        rn_blend += torch.where(walked, n_blend[:, s], 0)
        rlast = torch.where(walked & (last[:, s] >= 0), s * seg + last[:, s],
                            rlast)
        rdone = torch.where(walked, done[:, s], rdone)
        rewalk = active & pre[:, s]
        for j in range(seg if bool(rewalk.any()) else 0):
            live = rewalk & (rT > T_CUTOFF) & (j < nb[:, s, None])
            a = a_seg[:, s, j]
            rn_eval += live
            blend = live & (a > 0.0)
            racc = torch.where(blend[..., None], racc + (a * rT)[..., None]
                               * c_seg[:, s, j, None, :], racc)
            rT = torch.where(blend, rT * (1.0 - a), rT)
            rlast = torch.where(blend, s * seg + j, rlast)
            rn_blend += blend
        rdone = torch.where(rewalk, ~(rT > T_CUTOFF), rdone)
        if s < n_seg - 1:
            ckpt.append(torch.cat([rT[:, None], racc.permute(0, 2, 1)], 1))
    ckpt = torch.stack(ckpt, dim=1) if ckpt else \
        rT.new_zeros((num_tiles, 0, NCK, PIX))
    state = (rT, racc[..., :-1].contiguous(), racc[..., -1].contiguous())
    work = torch.stack([rn_eval, rn_blend], dim=1).to(torch.int32)
    return state, (rlast + 1).to(torch.int32), work, ckpt


def blend3d_bwd_segments_plain(conic, center, colors, depth, opac, pair_gid,
                               tile_start, tile_count, grid_x: int, gT, gC,
                               gD, chunk: int = 64, tile_cap: int = 4096,
                               seg: int = SEG, forward: tuple | None = None):
    """Plain emulation of K6's algorithm at segment length ``seg``: the
    gradients (d_conic, d_center, d_colors, d_depth, d_opac) of
    <(T, C, D), (gT, gC, gD)>.  ``forward`` is ``blend3d_segments_plain``'s
    result (computed at ``seg`` when not given).

    Every work item (tile t, segment s) at once: its post-state T from the
    checkpoint at its segment's end, or the final T where the segment ends
    the tile's walk, and the suffix sum there in closed form, R = gT T_f +
    g_c . (C_f - C_e) + g_d (D_f - D_e); then back to front over the
    segment's pairs, each blended pair (alpha > 0, before the pixel's
    n_walk) rebuilding its pre-blend T by a division, with K6's arithmetic.
    For the CPU tests of the algorithm."""
    state, n_walk, _, ckpt = forward if forward is not None else \
        blend3d_segments_plain(conic, center, colors, depth, opac, pair_gid,
                               tile_start, tile_count, grid_x, chunk,
                               tile_cap, seg)
    T_f, C_f, D_f = state
    dev = conic.device
    num_tiles = tile_start.shape[0]
    counts = torch.clamp(tile_count.long(), max=walk_cap(chunk, tile_cap))
    n_seg = ckpt.shape[1] + 1
    gid, con, cen, col, op, pix = _tile_pairs(
        conic, center, colors, depth, opac, pair_gid, tile_start, counts,
        grid_x, n_seg * seg)
    tile_walk = n_walk.amax(dim=1).long() if num_tiles else n_walk[:, 0]
    s0 = torch.arange(n_seg, device=dev) * seg
    s1 = torch.minimum(s0[None] + seg, tile_walk[:, None])          # [T, S]
    has_ck = (s1 < tile_walk[:, None])[..., None]
    ck = torch.cat([ckpt, ckpt.new_zeros((num_tiles, 1, NCK, PIX))], 1)
    g0, g1, g2 = (gC[:, None, :, i] for i in range(3))
    g_dep = gD[:, None]
    T = torch.where(has_ck, ck[:, :, 0], T_f[:, None])
    R = torch.where(has_ck, gT[:, None] * T_f[:, None]
                    + (g0 * (C_f[:, None, :, 0] - ck[:, :, 1])
                       + g1 * (C_f[:, None, :, 1] - ck[:, :, 2])
                       + g2 * (C_f[:, None, :, 2] - ck[:, :, 3])
                       + g_dep * (D_f[:, None] - ck[:, :, 4])),
                    gT[:, None] * T_f[:, None])
    px, py = pix[:, None, :, 0], pix[:, None, :, 1]
    grads = [torch.zeros_like(t) for t in (conic, center, colors, depth,
                                           opac)]
    for j in range(seg - 1, -1, -1):
        p = s0 + j                                                   # [S]
        g = gid[:, p]                                                # [T, S]
        a_, b_, c_ = (con[:, p, None, i] for i in range(3))
        dx = px - cen[:, p, None, 0]
        dy = py - cen[:, p, None, 1]
        power = -0.5 * (a_ * (dx * dx) + c_ * (dy * dy)) - (b_ * dx) * dy
        E = torch.exp(power)
        o = op[:, p, None]
        raw = o * E
        alpha = torch.clamp_max(raw, ALPHA_CLIP)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_CUTOFF), alpha,
                            0.0)
        blended = (p[None, :, None] < n_walk[:, None].long()) & (alpha > 0.0)
        a = torch.where(blended, alpha, 0.0)
        om = 1.0 - a
        Ti = T / om
        w = a * Ti
        f = col[:, p, None]                                   # [T, S, 1, 4]
        gw = g0 * f[..., 0] + g1 * f[..., 1] + g2 * f[..., 2] \
            + g_dep * f[..., 3]
        ga = Ti * gw - R / om
        graw = torch.where(raw <= ALPHA_CLIP, ga, 0.0)
        gp = graw * o * E
        per = [-0.5 * gp * (dx * dx), -gp * dx * dy, -0.5 * gp * (dy * dy),
               gp * (a_ * dx + b_ * dy), gp * (c_ * dy + b_ * dx),
               w * g0, w * g1, w * g2, w * g_dep, graw * E]
        sums = [torch.where(blended, v, 0.0).sum(dim=-1).flatten()
                for v in per]
        at = g.flatten()
        for out, lo, hi in zip(grads, (0, 3, 5, 8, 9), (3, 5, 8, 9, 10)):
            vals = torch.stack(sums[lo:hi], dim=-1)
            out.index_add_(0, at, vals.view(-1, *out.shape[1:]))
        R = torch.where(blended, R + w * gw, R)
        T = torch.where(blended, Ti, T)
    return tuple(grads)


def cull_power_plain(opac: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' per-pair cull threshold (float32):
    a pixel whose power lies below -ln(255 op) - CULL_MARGIN has alpha
    below 1/255 (csrc/raster3d.cu ``cull_power``)."""
    return -torch.log(255.0 * opac) - CULL_MARGIN


def _directed(hi, lo, up: bool):
    """The float32 rounding toward +inf (``up``) or -inf of the exact value
    hi + lo (float64 arrays, |lo| at most half an ulp of hi)."""
    r = hi.astype(np.float32)
    r64 = r.astype(np.float64)
    if up:
        return np.where((r64 < hi) | ((r64 == hi) & (lo > 0)),
                        np.nextafter(r, np.float32(np.inf)), r)
    return np.where((r64 > hi) | ((r64 == hi) & (lo < 0)),
                    np.nextafter(r, np.float32(-np.inf)), r)


def _add_dir(a, b, up: bool):
    """a + b of float32 arrays rounded toward +inf or -inf (__fadd_ru/rd):
    the float64 sum and its error, exact by TwoSum."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    s = a + b
    bb = s - a
    return _directed(s, (a - (s - bb)) + (b - bb), up)


def _mul_dir(a, b, up: bool):
    """a * b of float32 arrays rounded toward +inf or -inf (__fmul_ru/rd):
    the float64 product of two float32 values is exact."""
    return _directed(np.asarray(a, np.float64) * np.asarray(b, np.float64),
                     0.0, up)


def warp_refuses_plain(conic, center, cut, x0, y0) -> np.ndarray:
    """Plain version of the kernels' per-warp cull (csrc/raster3d.cu
    ``warp_refuses``), with the same directed roundings exactly, on numpy
    float32 arrays: conic [n, 3], center [n, 2], the pairs' cull powers
    [n] (``cull_power_plain``) and each test's warp corner x0, y0 [n] ->
    whether the pair is refused at every pixel px in [x0, x0 + 15], py in
    [y0, y0 + 1]."""
    f32 = lambda v: np.asarray(v, np.float32)
    a, b, c = (f32(conic[:, i]) for i in range(3))
    cx, cy = f32(center[:, 0]), f32(center[:, 1])
    x0, y0, cut = f32(x0), f32(y0), f32(cut)
    with np.errstate(over="ignore", invalid="ignore"):
        finite = np.isfinite(a) & np.isfinite(b) & np.isfinite(c) \
            & np.isfinite(cx) & np.isfinite(cy)
        dx_lo, dx_hi = _add_dir(x0, -cx, False), _add_dir(x0 + 15, -cx, True)
        dy_lo, dy_hi = _add_dir(y0, -cy, False), _add_dir(y0 + 1, -cy, True)

        def sq(lo, hi):
            m = np.fmin(np.abs(lo), np.abs(hi))
            big = np.fmax(np.abs(lo), np.abs(hi))
            return (np.where((lo <= 0) & (hi >= 0), np.float32(0),
                             _mul_dir(m, m, False)), _mul_dir(big, big, True))

        def mul_lo(s, lo, hi):
            return np.where(s >= 0, _mul_dir(s, lo, False),
                            _mul_dir(s, hi, False))

        def mul_hi(s, lo, hi):
            return np.where(s >= 0, _mul_dir(s, hi, True),
                            _mul_dir(s, lo, True))
        q_lo = _add_dir(mul_lo(a, *sq(dx_lo, dx_hi)),
                        mul_lo(c, *sq(dy_lo, dy_hi)), False)
        p1_hi = _mul_dir(np.float32(-0.5), q_lo, True)
        bx_lo, bx_hi = mul_lo(b, dx_lo, dx_hi), mul_hi(b, dx_lo, dx_hi)
        p2_lo = np.fmin(np.fmin(_mul_dir(bx_lo, dy_lo, False),
                                _mul_dir(bx_lo, dy_hi, False)),
                        np.fmin(_mul_dir(bx_hi, dy_lo, False),
                                _mul_dir(bx_hi, dy_hi, False)))
        power_hi = _add_dir(p1_hi, -p2_lo, True)
        return finite & np.isfinite(power_hi) & (power_hi < cut)
