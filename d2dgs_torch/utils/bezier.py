"""Bezier / piecewise trajectory interpolation (counterpart of
d2dgs_tpu/utils/bezier.py, the reference's utils/bezier.py): the editing
stack's handle trajectories.
"""
from __future__ import annotations

import torch


def de_casteljau(ctrl: torch.Tensor, t) -> torch.Tensor:
    """A Bezier curve with control points ctrl [K,D] at scalar or [T] t in
    [0,1], by the de Casteljau recursion.  Returns [D] or [T,D]."""
    t = torch.as_tensor(t, dtype=torch.float32, device=ctrl.device)
    scalar = t.dim() == 0
    t = torch.atleast_1d(t)[:, None, None]          # [T,1,1]
    pts = ctrl[None].expand((t.shape[0],) + tuple(ctrl.shape))
    for _ in range(ctrl.shape[0] - 1):
        pts = (1.0 - t) * pts[:, :-1] + t * pts[:, 1:]
    out = pts[:, 0]
    return out[0] if scalar else out


def bezier_trajectory(keypoints, times, n_ctrl: int = 4) -> torch.Tensor:
    """Smooth a [K,D] keypoint sequence and sample it at ``times`` in
    [0,1]: each span between successive keypoints is a cubic with its
    neighbours as tangent handles (Catmull-Rom as Bezier).  Returns
    [T,D]."""
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    times = torch.atleast_1d(torch.as_tensor(times, dtype=torch.float32,
                                             device=keypoints.device))
    k = keypoints.shape[0]
    if k == 1:
        return keypoints[0].expand(times.shape[0], keypoints.shape[1])
    # global parameterisation: segment index + local t
    seg_t = times * (k - 1)
    idx = torch.clamp(seg_t.to(torch.int64), 0, k - 2)
    lt = seg_t - idx
    p1 = keypoints[idx]
    p2 = keypoints[idx + 1]
    prev = keypoints[torch.clamp_min(idx - 1, 0)]
    nxt = keypoints[torch.clamp_max(idx + 2, k - 1)]
    tan1 = (p2 - prev) / 2.0
    tan2 = (nxt - p1) / 2.0
    c0, c1, c2, c3 = p1, p1 + tan1 / 3.0, p2 - tan2 / 3.0, p2
    u = lt[:, None]
    return ((1 - u) ** 3 * c0 + 3 * (1 - u) ** 2 * u * c1
            + 3 * (1 - u) * u ** 2 * c2 + u ** 3 * c3)
