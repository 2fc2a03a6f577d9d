"""The 3DGS (3-D covariance, EWA conic) rasterizer of the flow loss
(counterpart of d2dgs_tpu/ops/raster3d.py, the reference's bundled
diff-gaussian-rasterization: computeCov3D, computeCov2D, preprocessCUDA,
renderCUDA's conic blending).  It returns the 4-tuple (colour, radii,
depth, alpha) that ``render_flow`` consumes and bins its splats with the
surfel pipeline's ``bin_gaussians``.  On the card the tile blend is the
hand-written pair K5 (forward) and K6 (VJP) of ``csrc/raster3d.cu``
(``ops/cuda/raster3d.py``); on the CPU the same wrappers run
``blend3d_plain`` and its autograd VJP.

The JAX package walks each tile's pairs in chunks of ``cfg.chunk`` with a
nested ``lax.scan`` (pair by pair inside a chunk).  In ``blend3d_plain``
a chunk is one set of tensor ops: within a chunk the transmittance never
rises, so the pairs still blended (T > T_CUTOFF) are a prefix, and with
``P_i = T_start * prod_{j<i} (1 - a_j)`` the pair weights are
``a_i * P_i * [P_i > T_CUTOFF]`` and the chunk's end transmittance is
``P`` after that prefix.  ALPHA_CLIP keeps every factor >= 0.01, so the
product's backward is well defined.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import (ALPHA_CLIP, ALPHA_CUTOFF, NEAR_PLANE, T_CUTOFF, TILE,
                      RasterConfig)
from ..data.cameras import Camera
from ..utils.quaternion import quat_to_rotmat
from .binning import bin_gaussians
from .projection import Preprocessed, matmul_fma, tile_grid
from .tiled_raster import _tile_pixels, tiles_to_image

# renders and chunks of the plain walk (``blend3d_plain``) since the
# last reset, for callers that time the flow path (set both to 0 to
# start counting; on the CPU a backward walks once more, its VJP's
# recomputation); the kernel route counts its launches instead
WALK_COUNTS = {"renders": 0, "chunks": 0}


class Prep3D(NamedTuple):
    conic: torch.Tensor     # [N,3] inverse 2D covariance (a, b, c)
    center: torch.Tensor    # [N,2] pixel-space mean
    depth: torch.Tensor     # [N] view z
    radius: torch.Tensor    # [N] int32
    valid: torch.Tensor     # [N] bool
    rect_min: torch.Tensor  # [N,2] int32 tile coords
    rect_max: torch.Tensor  # [N,2]


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World covariance R diag(s^2) R^T, upper triangle [N,6]
    (computeCov3D).  Surfel scales [N,2] get a third axis of 1e-6; the
    2D low-pass keeps the projected footprint non-degenerate."""
    if scales.shape[-1] == 2:
        scales = torch.cat([scales, torch.full_like(scales[:, :1], 1e-6)],
                           dim=-1)
    s = scales * scale_modifier
    M = quat_to_rotmat(quats) * s[:, None, :]
    sigma = matmul_fma(M, M.transpose(1, 2))
    return torch.stack([sigma[:, 0, 0], sigma[:, 0, 1], sigma[:, 0, 2],
                        sigma[:, 1, 1], sigma[:, 1, 2], sigma[:, 2, 2]],
                       dim=-1)


def preprocess3d(means3d: torch.Tensor, scales: torch.Tensor,
                 quats: torch.Tensor, cam: Camera,
                 scale_modifier: float = 1.0,
                 cov3d_precomp: torch.Tensor | None = None) -> Prep3D:
    Rw = cam.w2c[:3, :3]
    tw = cam.w2c[:3, 3]
    t = matmul_fma(means3d[:, None, :], Rw.T)[:, 0] + tw
    in_front = t[:, 2] > NEAR_PLANE

    # pixel-space mean: fx*x/z + cx - 0.5 (ndc2Pix of the projection)
    tz = torch.where(t[:, 2] == 0, 1e-6, t[:, 2])
    center = torch.stack([cam.fx * t[:, 0] / tz + cam.W / 2.0 - 0.5,
                          cam.fy * t[:, 1] / tz + cam.H / 2.0 - 0.5],
                         dim=-1)

    # EWA: the Jacobian's linearisation point clamped to 1.3x the frustum
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    txz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tyz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    c = (compute_cov3d(scales, quats, scale_modifier)
         if cov3d_precomp is None else cov3d_precomp)
    Vrk = torch.stack([
        torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
        torch.stack([c[:, 1], c[:, 3], c[:, 4]], -1),
        torch.stack([c[:, 2], c[:, 4], c[:, 5]], -1)], -2)   # [N,3,3]

    z2 = tz * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([cam.fx / tz, zero, -cam.fx * txz / z2], -1),
        torch.stack([zero, cam.fy / tz, -cam.fy * tyz / z2], -1)], -2)
    JW = matmul_fma(J, Rw)                                    # [N,2,3]
    cov2d = matmul_fma(matmul_fma(JW, Vrk), JW.transpose(1, 2))  # [N,2,2]
    # low-pass: every splat at least ~1 px
    cxx = cov2d[:, 0, 0] + 0.3
    cxy = cov2d[:, 0, 1]
    cyy = cov2d[:, 1, 1] + 0.3

    det = cxx * cyy - cxy * cxy
    nondeg = det != 0.0
    det_safe = torch.where(nondeg, det, 1.0)
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe],
                        dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(
        3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))

    gx, gy = tile_grid(cam.H, cam.W)
    cx_p, cy_p = center[:, 0], center[:, 1]
    # the int cast truncates toward 0 and saturates like XLA's (see
    # ops/projection.py)
    i32 = lambda v, hi: torch.clamp(
        torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, hi + 1.0)
        .to(torch.int32), 0, hi)
    rmin_x = i32((cx_p - radius_f) / TILE, gx)
    rmin_y = i32((cy_p - radius_f) / TILE, gy)
    rmax_x = i32((cx_p + radius_f + TILE - 1) / TILE, gx)
    rmax_y = i32((cy_p + radius_f + TILE - 1) / TILE, gy)
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = in_front & nondeg & (area > 0)
    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    return Prep3D(conic=conic, center=center, depth=t[:, 2],
                  radius=radius, valid=valid,
                  rect_min=torch.stack([rmin_x, rmin_y], -1),
                  rect_max=torch.stack([rmax_x, rmax_y], -1))


def _as_surfel_prep(p: Prep3D) -> Preprocessed:
    """The fields ``bin_gaussians`` reads, for 3DGS splats."""
    n = p.depth.shape[0]
    dummy = torch.zeros((n, 3, 3), device=p.depth.device)
    return Preprocessed(T=dummy, normal=dummy[:, 0], depth=p.depth,
                        center=p.center, extent=p.center, radius=p.radius,
                        valid=p.valid, rect_min=p.rect_min,
                        rect_max=p.rect_max)


def _blend_chunk(T0, C0, D0, pix, con, cen, col, dz, op):
    """One chunk of pairs on a set of tiles: T0 [t,P], C0 [t,P,C], D0
    [t,P] the running state; pix [t,P,2]; per pair con [t,k,3], cen
    [t,k,2], col [t,k,C], dz [t,k], op [t,k] (0 past a tile's list).
    Returns the state after the chunk."""
    d = pix[:, None, :, :] - cen[:, :, None, :]              # [t,k,P,2]
    power = (-0.5 * (con[..., 0:1] * d[..., 0] ** 2
                     + con[..., 2:3] * d[..., 1] ** 2)
             - con[..., 1:2] * d[..., 0] * d[..., 1])
    alpha = torch.clamp_max(op[..., None] * torch.exp(power), ALPHA_CLIP)
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_CUTOFF), alpha,
                        torch.zeros_like(alpha))             # [t,k,P]
    # P_i = T0 * prod_{j<i} (1 - a_j), left to right as the scan rounds
    fac = torch.cat([T0[:, None, :], 1.0 - alpha], dim=1)    # [t,k+1,P]
    prod = torch.cumprod(fac, dim=1)
    live = prod[:, :-1] > T_CUTOFF                           # a prefix
    w = torch.where(live, alpha * prod[:, :-1], torch.zeros_like(alpha))
    n_live = live.sum(dim=1, keepdim=True)                   # [t,1,P]
    T1 = torch.gather(prod, 1, n_live)[:, 0]
    C1 = C0 + torch.einsum("tkp,tkc->tpc", w, col)
    D1 = D0 + torch.einsum("tkp,tk->tp", w, dz)
    return T1, C1, D1


def blend3d_plain(conic: torch.Tensor, center: torch.Tensor,
                  colors: torch.Tensor, depth: torch.Tensor,
                  opac: torch.Tensor, pair_gid: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  grid_x: int, chunk: int = 64, tile_cap: int = 4096):
    """The plain version of K5 (``csrc/raster3d.cu``): blend each tile's
    depth-ordered pairs ``pair_gid[tile_start[t]:][:tile_count[t]]`` (int32
    Gaussian ids) into its 256 pixels, ``chunk`` pairs at a time, with
    the per-Gaussian conic [N,3], centre [N,2], colours [N,C], view depth
    [N] and opacity [N] (0 for an invalid splat).  Returns the tile state
    (T [tiles, 256], colour sums [tiles, 256, C], depth sums [tiles,
    256]).

    As the JAX walk: pixels are sampled at their corners, and at most
    ``floor(tile_cap / chunk) * chunk`` pairs of a tile are blended.  The
    walk stops after the chunks the fullest tile needs,
    ``ceil(max tile_count / chunk)``; reading that bound (and which tiles
    reach each chunk) from the tile counts is one host synchronisation.
    Each chunk runs under ``torch.utils.checkpoint``, so the backward
    recomputes its [tiles, chunk, 256] intermediates instead of keeping
    them."""
    dev = conic.device
    C = colors.shape[-1]
    num_tiles = tile_start.shape[0]
    P = TILE * TILE
    k = chunk
    pix_all = _tile_pixels(grid_x, torch.arange(num_tiles, device=dev)) - 0.5
    counts = tile_count.cpu()                    # the one host sync
    n_chunks = max(tile_cap // k, 1)
    n_walk = min(-(-int(counts.max()) // k), n_chunks) if num_tiles else 0
    WALK_COUNTS["renders"] += 1
    WALK_COUNTS["chunks"] += n_walk
    gid = pair_gid.long()
    start = tile_start.long()
    end = start + tile_count.long()

    T_acc = torch.ones((num_tiles, P), device=dev)
    C_acc = torch.zeros((num_tiles, P, C), device=dev)
    D_acc = torch.zeros((num_tiles, P), device=dev)
    if n_walk == 0:
        # no pair (an empty view): the state still depends on the inputs,
        # with zero gradients, as the JAX scan's and the kernels' do, so a
        # backward through it gives zeros instead of raising (adding the
        # empty sums' +0.0 leaves every value as it is)
        link = sum(x[:0].sum() for x in (conic, center, colors, depth, opac))
        return T_acc + link, C_acc + link, D_acc + link
    arange_k = torch.arange(k, device=dev)
    for ci in range(n_walk):
        # the tiles whose lists reach this chunk; the rest are done
        tiles = torch.nonzero(counts > ci * k)[:, 0].to(dev)
        offs = start[tiles, None] + ci * k + arange_k[None]   # [t,k]
        ok = offs < end[tiles, None]
        ids = gid[torch.clamp(offs, max=gid.shape[0] - 1)]
        op = torch.where(ok, opac[ids], 0.0)
        T1, C1, D1 = checkpoint(
            _blend_chunk, T_acc[tiles], C_acc[tiles], D_acc[tiles],
            pix_all[tiles], conic[ids], center[ids], colors[ids],
            depth[ids], op, use_reentrant=False)
        T_acc = T_acc.index_copy(0, tiles, T1)
        C_acc = C_acc.index_copy(0, tiles, C1)
        D_acc = D_acc.index_copy(0, tiles, D1)
    return T_acc, C_acc, D_acc


def blend3d_inputs(means3d, scales, quats, opacities, colors, cam: Camera,
                   scale_modifier: float = 1.0, cov3d_precomp=None,
                   cfg: RasterConfig = RasterConfig()):
    """``preprocess3d`` and the binning of ``rasterize_3dgs`` (plain torch
    on either device; autograd carries their backward).  Returns (prep,
    the tile blend's arguments as ``blend3d_plain`` and ``Blend3D`` take
    them, each tensor contiguous)."""
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess3d(means3d, scales, quats, cam, scale_modifier,
                        cov3d_precomp)
    opac = torch.where(prep.valid, opacities.reshape(-1), 0.0)
    # circle cull with the exact conic bound (sigma_max = radius/3) and
    # the corner-sample rect convention of this blend
    binning = bin_gaussians(_as_surfel_prep(prep), gx, gy, cfg,
                            opacity=opac,
                            cull_sigma=prep.radius.to(torch.float32) / 3.0,
                            pixel_offset=0.0)
    tensors = (prep.conic, prep.center, colors, prep.depth, opac,
               binning.pair_gid, binning.tile_start, binning.tile_count)
    return prep, (*(t.contiguous() for t in tensors), gx, cfg.chunk,
                  cfg.tile_cap)


def blend3d_images(T_acc, C_acc, D_acc, bg, H: int, W: int):
    """The tile state of the blend (T, colour sums, depth sums) -> (image
    [H,W,C] = colour + T * bg, depth [H,W,1], alpha [H,W,1] = 1 - T)."""
    gx, gy = tile_grid(H, W)
    tile_color = C_acc + T_acc[..., None] * bg[None, None, :]
    image = tiles_to_image(tile_color, gx, gy, H, W)
    depth = tiles_to_image(D_acc[..., None], gx, gy, H, W)
    alpha_img = tiles_to_image(1.0 - T_acc[..., None], gx, gy, H, W)
    return image, depth, alpha_img


def rasterize_3dgs(means3d, scales, quats, opacities, colors, cam: Camera,
                   bg=None, scale_modifier: float = 1.0,
                   cov3d_precomp=None, cfg: RasterConfig = RasterConfig()):
    """The 3DGS pipeline.  colors: [N,C] precomputed (``render_flow``
    passes the uvz flow).  Returns (image [H,W,C], radii [N] int32,
    depth [H,W,1], alpha [H,W,1]), as the JAX function.

    ``preprocess3d`` and the binning are plain torch on either device
    (``blend3d_inputs``); the tile blend is ``Blend3D``, whose wrappers
    launch K5 and K6 on CUDA tensors (one launch each, no read of the
    counts; a build or launch failure raises) and run ``blend3d_plain``
    and its autograd VJP on CPU tensors."""
    from .cuda.raster3d import Blend3D
    C = colors.shape[-1]
    if bg is None:
        bg = torch.zeros((C,), dtype=torch.float32, device=means3d.device)
    prep, args = blend3d_inputs(means3d, scales, quats, opacities, colors,
                                cam, scale_modifier, cov3d_precomp, cfg)
    image, depth, alpha = blend3d_images(*Blend3D.apply(*args), bg, cam.H,
                                         cam.W)
    return image, prep.radius, depth, alpha
