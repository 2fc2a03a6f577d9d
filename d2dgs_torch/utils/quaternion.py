"""Quaternion utilities, wxyz convention (counterpart of
d2dgs_tpu/utils/quaternion.py)."""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / n


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternion -> [..., 3, 3] rotation matrix (columns are
    the rotated basis vectors).  Normalizes internally; the eps keeps the
    all-zero quaternions of dead capacity slots finite."""
    q = quat_normalize(q, eps=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real (w) part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 4] wxyz quaternion: the
    branchless sqrt-positive-part construction, the best-conditioned of
    four candidates per matrix (lap_deform.py:34-93 semantics)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def _psqrt(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    qw = 0.5 * _psqrt(1.0 + m00 + m11 + m22)
    qx = 0.5 * _psqrt(1.0 + m00 - m11 - m22)
    qy = 0.5 * _psqrt(1.0 - m00 + m11 - m22)
    qz = 0.5 * _psqrt(1.0 - m00 - m11 + m22)

    # four candidate reconstructions, each stable when its pivot is largest
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw + 1e-12),
                      (m02 - m20) / (4 * qw + 1e-12),
                      (m10 - m01) / (4 * qw + 1e-12)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qx + 1e-12), qx,
                      (m01 + m10) / (4 * qx + 1e-12),
                      (m02 + m20) / (4 * qx + 1e-12)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qy + 1e-12),
                      (m01 + m10) / (4 * qy + 1e-12), qy,
                      (m12 + m21) / (4 * qy + 1e-12)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qz + 1e-12),
                      (m02 + m20) / (4 * qz + 1e-12),
                      (m12 + m21) / (4 * qz + 1e-12), qz], -1)

    best = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)[..., None]
    q = torch.where(best == 0, c0,
                    torch.where(best == 1, c1,
                                torch.where(best == 2, c2, c3)))
    return standardize_quaternion(quat_normalize(q, eps=1e-12))
