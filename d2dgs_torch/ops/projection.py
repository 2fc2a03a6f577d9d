"""Per-Gaussian preprocessing: surfel->screen transform, AABB, culling
(counterpart of d2dgs_tpu/ops/projection.py, reference forward.cu:73-260).

* ``T = K [s_x W R_0 | s_y W R_1 | p_view]`` maps the splat's tangent
  plane (u, v, 1) to screen (x z, y z, z), 2DGS Eq. 5-7.
* AABB center/extent come from T; frustum cull at z <= 0.2,
  backface/degenerate cull and the dual-visible normal flip as in the
  reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FILTER_SIZE, NEAR_PLANE, TILE, TRUNCATED_R
from ..data.cameras import Camera
from ..utils.quaternion import quat_to_rotmat


class Preprocessed(NamedTuple):
    T: torch.Tensor        # [N, 3, 3] rows (Tu, Tv, Tw)
    normal: torch.Tensor   # [N, 3] camera-frame splat normal (sign-flipped)
    depth: torch.Tensor    # [N] view-space z
    center: torch.Tensor   # [N, 2] screen-space AABB center
    extent: torch.Tensor   # [N, 2] AABB half-extent (1 sigma)
    radius: torch.Tensor   # [N] int32 screen radius in pixels (0 if culled)
    valid: torch.Tensor    # [N] bool
    rect_min: torch.Tensor  # [N, 2] int32 tile coords (x, y), inclusive
    rect_max: torch.Tensor  # [N, 2] int32 tile coords, exclusive


def tile_grid(H: int, W: int) -> tuple[int, int]:
    return (-(-W // TILE), -(-H // TILE))  # (tiles_x, tiles_y)


def matmul_fma(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for a short contracted axis (3 or 4), summed as XLA
    compiles the JAX package's float32 dots and einsums on the CPU: a
    fused multiply-add chain ``fma(a2, b2, fma(a1, b1, a0 b0))``.
    ``addcmul`` fuses its multiply-add on either device; a BLAS GEMM
    rounds each product and sum apart, 1 ulp off in about a third of the
    entries."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        out = torch.addcmul(out, A[..., :, k:k + 1], B[..., k:k + 1, :])
    return out


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               quats: torch.Tensor, cam: Camera,
               scale_modifier: float = 1.0) -> Preprocessed:
    """means3d [N,3], scales [N,2] (linear, post-activation), quats [N,4]."""
    Rw = cam.w2c[:3, :3]
    tw = cam.w2c[:3, 3]
    p_view = matmul_fma(means3d[:, None, :], Rw.T)[:, 0] + tw   # [N,3]
    in_front = p_view[:, 2] > NEAR_PLANE

    R = quat_to_rotmat(quats)                          # [N,3,3]
    WR = matmul_fma(Rw, R)                             # [N,3,3]
    s = scales * scale_modifier
    M0 = WR[:, :, 0] * s[:, 0:1]                       # tangent axis u
    M1 = WR[:, :, 1] * s[:, 1:2]                       # tangent axis v
    tn = WR[:, :, 2]                                   # unit normal

    cosang = -torch.sum(tn * p_view, dim=-1)
    # dual-visible flip; cos==0 backface cull
    tn = torch.where(cosang[:, None] > 0, tn, -tn)
    not_edge_on = cosang != 0.0

    # splat-to-screen homogeneous transform: rows (Tu, Tv, Tw)
    Smat = torch.stack([M0, M1, p_view], dim=-1)       # [N,3,3] columns
    T = matmul_fma(cam.K, Smat)
    Tu, Tv, Tw = T[:, 0, :], T[:, 1, :], T[:, 2, :]

    # AABB from T (forward.cu:133-163)
    f_sign = torch.tensor([1.0, 1.0, -1.0], dtype=T.dtype, device=T.device)
    d = torch.sum(f_sign * Tw * Tw, dim=-1)
    nondegenerate = d != 0.0
    d_safe = torch.where(nondegenerate, d, torch.ones_like(d))
    f = f_sign / d_safe[:, None]
    cx = torch.sum(f * Tu * Tw, dim=-1)
    cy = torch.sum(f * Tv * Tw, dim=-1)
    ex = torch.sqrt(torch.clamp_min(cx * cx - torch.sum(f * Tu * Tu, dim=-1),
                                    0.0))
    ey = torch.sqrt(torch.clamp_min(cy * cy - torch.sum(f * Tv * Tv, dim=-1),
                                    0.0))
    center = torch.stack([cx, cy], dim=-1)
    extent = torch.stack([ex, ey], dim=-1)

    radius_f = torch.ceil(
        TRUNCATED_R * torch.clamp_min(torch.maximum(ex, ey), FILTER_SIZE))

    # tile rect (auxiliary.h getRect:64-74).  The int cast truncates
    # toward 0 and saturates like XLA's: clamping first keeps inf/NaN
    # (degenerate splats) out of the undefined range of the cast.
    gx, gy = tile_grid(cam.H, cam.W)
    i32 = lambda v, hi: torch.clamp(
        torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, hi + 1.0)
        .to(torch.int32), 0, hi)
    rmin_x = i32((cx - radius_f) / TILE, gx)
    rmin_y = i32((cy - radius_f) / TILE, gy)
    rmax_x = i32((cx + radius_f + TILE - 1) / TILE, gx)
    rmax_y = i32((cy + radius_f + TILE - 1) / TILE, gy)
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = in_front & not_edge_on & nondegenerate & (area > 0)
    radius = torch.where(valid, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    return Preprocessed(
        T=T, normal=tn, depth=p_view[:, 2], center=center, extent=extent,
        radius=radius, valid=valid,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
    )
