"""Dual-quaternion rigid-transform blending, DQB (counterpart of
d2dgs_tpu/utils/dual_quaternion.py), the ``skinning="dqb"`` option of
``models/nodes.warp``.

Convention: wxyz real part, dual part = 0.5 * t_quat (x) q_real.
"""
from __future__ import annotations

import torch

from .quaternion import quat_normalize, quat_raw_multiply

_CONJ = (1.0, -1.0, -1.0, -1.0)


def _conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor(_CONJ, dtype=q.dtype, device=q.device)


def rigid_to_dq(q: torch.Tensor, t: torch.Tensor):
    """(rotation quat [.,4], translation [.,3]) -> (real [.,4], dual [.,4])."""
    q = quat_normalize(q, eps=1e-12)
    tq = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return q, 0.5 * quat_raw_multiply(tq, q)


def dq_to_rigid(real: torch.Tensor, dual: torch.Tensor):
    """Normalised dq -> (rotation quat, translation)."""
    w = torch.sqrt(torch.sum(real * real, dim=-1, keepdim=True) + 1e-12)
    real, dual = real / w, dual / w
    t = 2.0 * quat_raw_multiply(dual, _conj(real))[..., 1:]
    return real, t


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [.,3] by unit quats q [.,4]."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_raw_multiply(quat_raw_multiply(q, qv), _conj(q))[..., 1:]


def dq_blend(q: torch.Tensor, t: torch.Tensor, weight: torch.Tensor):
    """Weighted DQB: q [N,K,4] per-neighbour rotation quats, t [N,K,3]
    translations, weight [N,K] (rows sum to 1).  Returns (q_blend [N,4],
    t_blend [N,3]).

    Each dq is sign-corrected against the highest-weight neighbour's (the
    first of equal weights, as ``jnp.argmax`` picks): antipodal quats are
    one rotation but cancel in a linear blend.  The flip is strict: a dq
    orthogonal to the pivot keeps its sign."""
    real, dual = rigid_to_dq(q, t)
    pivot_idx = torch.argmax(weight, dim=-1)
    pivot = torch.gather(real, 1, pivot_idx[:, None, None].expand(-1, 1, 4)
                         )[:, 0]
    dot = torch.sum(real * pivot[:, None, :], dim=-1)
    sign = torch.where(dot < 0, -1.0, 1.0).to(real.dtype)
    real = real * sign[..., None]
    dual = dual * sign[..., None]
    rb = torch.sum(real * weight[..., None], dim=1)
    db = torch.sum(dual * weight[..., None], dim=1)
    return dq_to_rigid(rb, db)
