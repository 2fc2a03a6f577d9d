"""Quaternion utilities, wxyz convention (counterpart of d2dgs_tpu/utils/quaternion.py)."""
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
