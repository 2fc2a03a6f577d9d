"""Wrapper of the blend forward kernel ``csrc/blend_fwd.cu``.

The kernel replaces ``_fwd_wq_kernel`` of
d2dgs_tpu/ops/pallas/blend_tpu.py: it blends every tile's depth-sorted
pair list into the state rows [T, NSTATE, PIX] (layout ROW_* in
ops/tiled_raster.py).  Its plain PyTorch version is
``blend_tiles_plain``.  The backward kernel is not ported yet, so a CUDA
input that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..tiled_raster import NFEAT, NSTATE, PIX, blend_tiles_plain
from . import build

SOURCE = "blend_fwd.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.blend_fwd_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.blend_fwd_launch.restype = ctypes.c_int
    lib.blend_fwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_fwd_error_string.restype = ctypes.c_char_p
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


def blend_fwd(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
              tile_start: torch.Tensor, tile_count: torch.Tensor,
              grid_x: int, chunk: int = 64) -> torch.Tensor:
    """Blend every tile: feats_sorted [N, NFEAT] float32 (depth order),
    pair_rank [B], tile_start [T], tile_count [T] int32 -> state rows
    [T, NSTATE, PIX] float32.

    On CPU tensors this is ``blend_tiles_plain`` (which steps ``chunk``
    pairs at a time); on CUDA tensors it launches the kernel, which
    stages its own 256-pair batches, or raises.
    """
    if feats_sorted.device.type == "cpu":
        return blend_tiles_plain(feats_sorted, pair_rank, tile_start,
                                 tile_count, grid_x, chunk=chunk)
    dev = feats_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cpu or cuda, not {dev}")
    if feats_sorted.requires_grad:
        raise NotImplementedError(
            "blend_fwd has no backward kernel yet (the K2 port, ROADMAP.md); "
            "call it under torch.no_grad() or on detached inputs")
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
    state = torch.empty((num_tiles, NSTATE, PIX), dtype=torch.float32,
                        device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_fwd_launch(
            feats_sorted.data_ptr(), pair_rank.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, grid_x,
            state.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_fwd kernel launch failed: "
                           + lib.blend_fwd_error_string(err).decode())
    blend_fwd.launches += 1
    return state


blend_fwd.launches = 0
