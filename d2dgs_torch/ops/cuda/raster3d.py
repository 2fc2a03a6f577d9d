"""Wrappers of the 3DGS flow blend kernels ``csrc/raster3d.cu``: K5
(``blend3d_fwd``, the forward) and K6 (``blend3d_bwd``, its VJP), and
``Blend3D``, the autograd function that pairs them.

They replace the blend of the JAX package's ``rasterize_3dgs``
(d2dgs_tpu/ops/raster3d.py:140-225, a ``lax.scan`` that XLA compiles; no
Pallas kernel).  The plain PyTorch version is
``ops/raster3d.blend3d_plain``; on CPU tensors the wrappers use it (K6's
through autograd), on CUDA tensors they launch the kernel or raise.  The
kernels are built for C = 3 colour channels (the flow path's) only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..raster3d import blend3d_plain
from ..tiled_raster import PIX
from . import build
from .blend import _check, _ptr

SOURCE = "raster3d.cu"
CHANNELS = 3          # the colour channels the kernels are built for


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.raster3d_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
    lib.raster3d_fwd_launch.restype = ctypes.c_int
    lib.raster3d_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 11
    lib.raster3d_bwd_launch.restype = ctypes.c_int
    lib.raster3d_error_string.argtypes = [ctypes.c_int]
    lib.raster3d_error_string.restype = ctypes.c_char_p
    return lib


def walk_cap(chunk: int, tile_cap: int) -> int:
    """The most pairs of a tile the blend walks: floor(tile_cap / chunk)
    chunks of ``chunk`` pairs, at least one, as the JAX scan."""
    return max(tile_cap // chunk, 1) * chunk


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


def _raise(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().raster3d_error_string(err).decode())


def blend3d_fwd(conic, center, colors, depth, opac, pair_gid, tile_start,
                tile_count, grid_x: int, chunk: int = 64,
                tile_cap: int = 4096, n_walk: torch.Tensor | None = None,
                work: torch.Tensor | None = None):
    """The tile state (T [T, PIX], colour sums [T, PIX, C], depth sums
    [T, PIX]) of the blend of each tile's pairs (``blend3d_plain``'s
    arguments).  On CPU tensors this is ``blend3d_plain``; on CUDA
    tensors it launches K5 (one CTA per tile) or raises.  ``n_walk``
    (optional int32 [T, PIX]) receives the pairs each pixel walked up to
    its last blended one, K6's input; ``work`` (optional int32 [T, 2,
    PIX]) each pixel's evaluated and blended pair counts."""
    dev = conic.device
    if dev.type == "cpu":
        return blend3d_plain(conic, center, colors, depth, opac, pair_gid,
                             tile_start, tile_count, grid_x, chunk, tile_cap)
    if dev.type != "cuda":
        raise ValueError(f"blend3d_fwd runs on cpu or cuda, not {dev}")
    _, c = check_inputs(conic, center, colors, depth, opac, pair_gid,
                        tile_start, tile_count)
    num_tiles = tile_start.shape[0]
    for name, t, shape in (("n_walk", n_walk, (num_tiles, PIX)),
                           ("work", work, (num_tiles, 2, PIX))):
        if t is not None:
            _check(name, t, torch.int32, len(shape), dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got "
                                 f"{tuple(t.shape)}")
    T = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    C = torch.empty((num_tiles, PIX, c), dtype=torch.float32, device=dev)
    D = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster3d_fwd_launch(
            conic.data_ptr(), center.data_ptr(), colors.data_ptr(),
            depth.data_ptr(), opac.data_ptr(), pair_gid.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, grid_x,
            walk_cap(chunk, tile_cap), c, T.data_ptr(), C.data_ptr(),
            D.data_ptr(), _ptr(n_walk), _ptr(work), stream)
    _raise(err, "blend3d_fwd")
    blend3d_fwd.launches += 1
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
                tile_count, grid_x: int, T, n_walk, gT, gC, gD,
                chunk: int = 64, tile_cap: int = 4096):
    """The gradients (d_conic, d_center, d_colors, d_depth, d_opac) of the
    blend for the cotangents gT [T, PIX], gC [T, PIX, C], gD [T, PIX] of
    its outputs, from K5's final ``T`` and ``n_walk``.  On CPU tensors
    this is ``blend3d_plain_vjp`` (``T`` and ``n_walk`` unused); on CUDA
    tensors it launches K6 (one CTA per tile) or raises."""
    dev = conic.device
    if dev.type == "cpu":
        return blend3d_plain_vjp(conic, center, colors, depth, opac,
                                 pair_gid, tile_start, tile_count, grid_x,
                                 gT, gC, gD, chunk, tile_cap)
    if dev.type != "cuda":
        raise ValueError(f"blend3d_bwd runs on cpu or cuda, not {dev}")
    _, c = check_inputs(conic, center, colors, depth, opac, pair_gid,
                        tile_start, tile_count)
    num_tiles = tile_start.shape[0]
    for name, t, dtype, shape in (
            ("T", T, torch.float32, (num_tiles, PIX)),
            ("n_walk", n_walk, torch.int32, (num_tiles, PIX)),
            ("gT", gT, torch.float32, (num_tiles, PIX)),
            ("gC", gC, torch.float32, (num_tiles, PIX, c)),
            ("gD", gD, torch.float32, (num_tiles, PIX))):
        _check(name, t, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    grads = [torch.zeros_like(t) for t in (conic, center, colors, depth,
                                           opac)]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster3d_bwd_launch(
            conic.data_ptr(), center.data_ptr(), colors.data_ptr(),
            depth.data_ptr(), opac.data_ptr(), pair_gid.data_ptr(),
            tile_start.data_ptr(), num_tiles, grid_x, c, T.data_ptr(),
            n_walk.data_ptr(), gT.data_ptr(), gC.data_ptr(), gD.data_ptr(),
            *(g.data_ptr() for g in grads), stream)
    _raise(err, "blend3d_bwd")
    blend3d_bwd.launches += 1
    return tuple(grads)


blend3d_bwd.launches = 0


class Blend3D(torch.autograd.Function):
    """The tile state (T, colour sums, depth sums) of the 3DGS blend,
    differentiable in conic, center, colors, depth and opac: forward
    ``blend3d_fwd``, backward ``blend3d_bwd`` (K5 and K6 on CUDA tensors,
    whose gathers through ``pair_gid`` and sums of each Gaussian's
    gradient over its pairs happen in the kernels; the plain walk and
    its autograd VJP on CPU tensors)."""

    @staticmethod
    def forward(ctx, conic, center, colors, depth, opac, pair_gid,
                tile_start, tile_count, grid_x, chunk=64, tile_cap=4096):
        n_walk = torch.empty((tile_start.shape[0], PIX), dtype=torch.int32,
                             device=conic.device)
        T, C, D = blend3d_fwd(conic, center, colors, depth, opac, pair_gid,
                              tile_start, tile_count, grid_x, chunk,
                              tile_cap, n_walk=n_walk)
        ctx.save_for_backward(conic, center, colors, depth, opac, pair_gid,
                              tile_start, tile_count, T, n_walk)
        ctx.grid_x, ctx.chunk, ctx.tile_cap = grid_x, chunk, tile_cap
        return T, C, D

    @staticmethod
    def backward(ctx, gT, gC, gD):
        *inputs, T, n_walk = ctx.saved_tensors
        grads = blend3d_bwd(*inputs, ctx.grid_x, T, n_walk, gT.contiguous(),
                            gC.contiguous(), gD.contiguous(),
                            chunk=ctx.chunk, tile_cap=ctx.tile_cap)
        return (*grads, None, None, None, None, None, None)
