"""Wrappers of the blend kernels ``csrc/blend_fwd.cu`` (K1) and
``csrc/blend_bwd.cu`` (K2), and ``BlendTiles``, the autograd function
that pairs them.

K1 replaces ``_fwd_wq_kernel`` of d2dgs_tpu/ops/pallas/blend_tpu.py: it
blends every tile's depth-sorted pair list into the state rows
[T, NSTATE, PIX] (layout ROW_* in ops/tiled_raster.py); its plain
PyTorch version is ``blend_tiles_plain``.  K2 replaces
``_bwd_wq_kernel``: from K1's state and per-pixel records it computes the
gradient of the 18 sorted feature columns; its plain PyTorch version is
``blend_tiles_plain_vjp`` below.  The same two libraries also hold K3
and K4, the dense route's entry points (wrapped in blend_dense.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..tiled_raster import (NFEAT, NSTATE, PIX, ROW_D1, ROW_D2, ROW_DONE,
                            ROW_N_BLEND, ROW_N_EVAL, blend_tiles_plain)
from . import build

SOURCE = "blend_fwd.cu"
SOURCE_BWD = "blend_bwd.cu"
# K1's per-pixel training records: the positions in the tile's pair list
# of the last blended pair (row REC_LAST) and of the median pair (row 1)
NREC = 2
REC_LAST = 0
# state rows whose cotangent K2 takes as zero, as the TPU kernel does:
# done, the final dist1/dist2 and the two work counters
DEAD_ROWS = (ROW_DONE, ROW_D1, ROW_D2, ROW_N_EVAL, ROW_N_BLEND)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.blend_fwd_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.blend_fwd_launch.restype = ctypes.c_int
    lib.blend_dense_fwd_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.blend_dense_fwd_launch.restype = ctypes.c_int
    lib.blend_fwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = build.load(SOURCE_BWD)
    lib.blend_bwd_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.blend_bwd_launch.restype = ctypes.c_int
    lib.blend_dense_bwd_launch.argtypes = [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    lib.blend_dense_bwd_launch.restype = ctypes.c_int
    lib.blend_bwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pairs(feats_sorted, pair_rank, tile_start, tile_count, grid_x):
    """Device, type and shape checks shared by both kernels; returns the
    tile count."""
    dev = feats_sorted.device
    _check("feats_sorted", feats_sorted, torch.float32, 2, dev)
    _check("pair_rank", pair_rank, torch.int32, 1, dev)
    _check("tile_start", tile_start, torch.int32, 1, dev)
    _check("tile_count", tile_count, torch.int32, 1, dev)
    if feats_sorted.shape[1] != NFEAT:
        raise ValueError(f"feats_sorted must be [N, {NFEAT}], got "
                         f"{tuple(feats_sorted.shape)}")
    num_tiles = tile_start.shape[0]
    if tile_count.shape[0] != num_tiles or grid_x <= 0 \
            or num_tiles % grid_x != 0:
        raise ValueError(f"tile arrays {tuple(tile_start.shape)}/"
                         f"{tuple(tile_count.shape)} do not form a grid "
                         f"{grid_x} tiles wide")
    return num_tiles


def _check_rows(name, t, dtype, rows, num_tiles, device):
    _check(name, t, dtype, 3, device)
    if tuple(t.shape) != (num_tiles, rows, PIX):
        raise ValueError(f"{name} must be [{num_tiles}, {rows}, {PIX}], got "
                         f"{tuple(t.shape)}")


def blend_fwd(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
              tile_start: torch.Tensor, tile_count: torch.Tensor,
              grid_x: int, chunk: int = 64,
              records: torch.Tensor | None = None) -> torch.Tensor:
    """Blend every tile: feats_sorted [N, NFEAT] float32 (depth order),
    pair_rank [B], tile_start [T], tile_count [T] int32 -> state rows
    [T, NSTATE, PIX] float32.

    ``records`` ([T, NREC, PIX] int32, optional) receives K1's training
    records for K2: per pixel the position in its tile's pair list of the
    last blended pair and of the median pair (-1 for none).  On CPU
    tensors this is ``blend_tiles_plain`` (which steps ``chunk`` pairs at
    a time) and ``records`` is left as it is, since the plain backward
    needs none; on CUDA tensors it launches the kernel, which stages its
    own 256-pair batches, or raises.
    """
    if feats_sorted.device.type == "cpu":
        return blend_tiles_plain(feats_sorted, pair_rank, tile_start,
                                 tile_count, grid_x, chunk=chunk)
    dev = feats_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cpu or cuda, not {dev}")
    num_tiles = _check_pairs(feats_sorted, pair_rank, tile_start, tile_count,
                             grid_x)
    if records is not None:
        _check_rows("records", records, torch.int32, NREC, num_tiles, dev)
    state = torch.empty((num_tiles, NSTATE, PIX), dtype=torch.float32,
                        device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_fwd_launch(
            feats_sorted.data_ptr(), pair_rank.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, grid_x,
            state.data_ptr(),
            None if records is None else records.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_fwd kernel launch failed: "
                           + lib.blend_fwd_error_string(err).decode())
    blend_fwd.launches += 1
    return state


blend_fwd.launches = 0


def blend_tiles_plain_vjp(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
                          tile_start: torch.Tensor, tile_count: torch.Tensor,
                          grid_x: int, g_state: torch.Tensor,
                          tiles: torch.Tensor | None = None,
                          chunk: int = 64) -> torch.Tensor:
    """Plain version of K2: the gradient of <state, g_state> in
    feats_sorted [N, NFEAT], by autograd through ``blend_tiles_plain``.

    The cotangents of ``DEAD_ROWS`` are taken as zero, as K2 does.
    ``tiles`` (optional, int64 tile indices) restricts the blend to those
    tiles, at their true pixel coordinates, so the plain version can be
    held against K2 on a full-width view without saving every tile's
    chunk intermediates."""
    g = g_state.clone()
    g[:, list(DEAD_ROWS)] = 0.0
    if tiles is not None:
        tile_start, tile_count, g = tile_start[tiles], tile_count[tiles], \
            g[tiles]
    with torch.enable_grad():
        f = feats_sorted.detach().requires_grad_()
        state = blend_tiles_plain(f, pair_rank, tile_start, tile_count,
                                  grid_x, chunk=chunk, tile_ids=tiles)
        if not state.requires_grad:       # no pairs in these tiles
            return torch.zeros_like(f)
        d_feats, = torch.autograd.grad(state, f, g)
    return d_feats


def blend_bwd(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
              tile_start: torch.Tensor, tile_count: torch.Tensor,
              grid_x: int, state: torch.Tensor, records: torch.Tensor,
              g_state: torch.Tensor, chunk: int = 64,
              n_reduce: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the blend in feats_sorted: K1's inputs, its ``state``
    and ``records``, and the cotangent ``g_state`` [T, NSTATE, PIX] ->
    d_feats_sorted [N, NFEAT] float32.

    On CPU tensors this is ``blend_tiles_plain_vjp`` (``state`` and
    ``records`` unused); on CUDA tensors it launches the kernel or raises.
    ``n_reduce`` (optional int64 [1] on the card) is incremented by the
    number of (warp, pair) sums the kernel issued, 18 atomics each.
    """
    if feats_sorted.device.type == "cpu":
        return blend_tiles_plain_vjp(feats_sorted, pair_rank, tile_start,
                                     tile_count, grid_x, g_state, chunk=chunk)
    dev = feats_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"blend_bwd runs on cpu or cuda, not {dev}")
    num_tiles = _check_pairs(feats_sorted, pair_rank, tile_start, tile_count,
                             grid_x)
    _check_rows("state", state, torch.float32, NSTATE, num_tiles, dev)
    _check_rows("records", records, torch.int32, NREC, num_tiles, dev)
    _check_rows("g_state", g_state, torch.float32, NSTATE, num_tiles, dev)
    if n_reduce is not None:
        _check("n_reduce", n_reduce, torch.int64, 1, dev)
    d_feats = torch.zeros_like(feats_sorted)
    lib = _lib_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_bwd_launch(
            feats_sorted.data_ptr(), pair_rank.data_ptr(),
            tile_start.data_ptr(), num_tiles, grid_x, state.data_ptr(),
            records.data_ptr(), g_state.data_ptr(), d_feats.data_ptr(),
            None if n_reduce is None else n_reduce.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_bwd kernel launch failed: "
                           + lib.blend_bwd_error_string(err).decode())
    blend_bwd.launches += 1
    return d_feats


blend_bwd.launches = 0


class BlendTiles(torch.autograd.Function):
    """State rows of the blend, differentiable in feats_sorted: forward
    K1 in training mode, backward K2.  The gather ``feats[order]`` stays
    outside, so autograd sums the per-rank gradients per Gaussian."""

    @staticmethod
    def forward(ctx, feats_sorted, pair_rank, tile_start, tile_count,
                grid_x, chunk=64):
        records = torch.empty((tile_start.shape[0], NREC, PIX),
                              dtype=torch.int32, device=feats_sorted.device)
        state = blend_fwd(feats_sorted, pair_rank, tile_start, tile_count,
                          grid_x, chunk=chunk, records=records)
        ctx.save_for_backward(feats_sorted, pair_rank, tile_start,
                              tile_count, state, records)
        ctx.grid_x, ctx.chunk = grid_x, chunk
        return state

    @staticmethod
    def backward(ctx, g_state):
        feats_sorted, pair_rank, tile_start, tile_count, state, records = \
            ctx.saved_tensors
        d_feats = blend_bwd(feats_sorted, pair_rank, tile_start, tile_count,
                            ctx.grid_x, state, records,
                            g_state.contiguous(), chunk=ctx.chunk)
        return d_feats, None, None, None, None, None
