"""Deformation-field facade (counterpart of d2dgs_tpu/models/deform.py, the
reference's DeformModel) for the ``node`` and ``static`` types.  The
``mlp`` and ``hash`` fields are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from .deform_mlp import MLPConfig
from .nodes import NodeConfig, NodeParams, warp


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    deform_type: str = "node"          # node | static (mlp, hash: later)
    node: NodeConfig = NodeConfig()
    mlp: MLPConfig = MLPConfig()


def deform_gaussians(nodes: NodeParams, cfg: DeformConfig,
                     xyz: torch.Tensor, t, feature=None, motion_mask=None,
                     step=10**9) -> dict:
    """-> dict(d_xyz, d_rotation, d_scaling, d_opacity, d_color) for the
    Gaussians at ``xyz`` at time ``t`` (DeformModel.step)."""
    n = xyz.shape[0]
    if cfg.deform_type == "node":
        mm = (motion_mask if motion_mask is not None
              else torch.ones((n, 1), dtype=torch.float32,
                              device=xyz.device))
        return warp(nodes, cfg.node, xyz, t, feature=feature,
                    motion_mask=mm, step=step)
    if cfg.deform_type == "static":
        z = lambda c: torch.zeros((n, c), dtype=torch.float32,
                                  device=xyz.device)
        return {"d_xyz": z(3), "d_rotation": z(4), "d_scaling": z(2),
                "d_opacity": None, "d_color": None}
    if cfg.deform_type in ("mlp", "hash"):
        raise NotImplementedError(
            f"deform_type {cfg.deform_type!r} is not ported yet; see the "
            f"port's module queue in ROADMAP.md")
    raise ValueError(f"unknown deform_type {cfg.deform_type!r}")
