"""Densification statistics (counterpart of d2dgs_tpu/models/densify.py).

The screen-space gradient norm of every visible Gaussian is accumulated
per step (gaussian_model.py:484-486), with the observation count and the
largest screen radius.  ``densify_and_prune`` and ``reset_opacity`` are
not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor   # [C] accumulated view-space grad norms
    denom: torch.Tensor        # [C] observation counts
    max_radii2d: torch.Tensor  # [C]


def init_stats(capacity: int, device) -> DensifyStats:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyStats(z(), z(), z())


def add_stats(stats: DensifyStats, screen_grad: torch.Tensor,
              visible: torch.Tensor, radii: torch.Tensor) -> DensifyStats:
    """screen_grad: [C,2] gradient of the zero-valued screen probe (see
    render/renderer.py); accumulate its norm for visible Gaussians and
    track the largest screen radius (train_gui.py:389-391)."""
    g = torch.linalg.vector_norm(screen_grad, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, g, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(visible, radii, 0.0)))
