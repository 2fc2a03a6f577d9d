"""Deformation-field facade (counterpart of d2dgs_tpu/models/deform.py, the
reference's DeformModel, scene/deform_model.py:10-72), dispatching on
``deform_type``:

* "node"   — control-node skinning (models/nodes.py), the D-2DGS default;
* "mlp"    — the deform MLP queried directly at each Gaussian
             (DeformNetwork, utils/time_utils.py:208-459);
* "hash"   — the multi-resolution hash-grid field (models/hash_deform.py);
* "static" — no deformation (StaticNetwork, time_utils.py:462-470).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .. import trace
from ..utils.general import resolve_device
from .deform_mlp import MLPConfig, init_mlp, mlp_forward
from .hash_deform import HashConfig, hash_deform_forward, init_hash_deform
from .nodes import (NodeConfig, NodeParams, init_node_params,
                    init_nodes_from_pcl, warp)


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    deform_type: str = "node"          # node | mlp | hash | static
    node: NodeConfig = NodeConfig()
    mlp: MLPConfig = MLPConfig()
    hash: HashConfig = HashConfig()


def init_deform(cfg: DeformConfig, generator: torch.Generator | None = None,
                device="cuda", init_pcl=None):
    """The chosen field's parameters, drawn on the CPU from ``generator``:
    a NodeParams for "node" (its nodes FPS-sampled from ``init_pcl`` when
    given), else an ``nn.ModuleDict`` (empty for "static")."""
    dev = resolve_device(device)
    if cfg.deform_type == "node":
        params = init_node_params(cfg.node, generator, device=dev)
        if init_pcl is not None:
            init_nodes_from_pcl(
                params, cfg.node,
                torch.as_tensor(np.asarray(init_pcl, np.float32)),
                generator=generator)
        return params
    if cfg.deform_type == "mlp":
        return init_mlp(cfg.mlp, generator, dev)
    if cfg.deform_type == "hash":
        return init_hash_deform(cfg.hash, generator, dev)
    if cfg.deform_type == "static":
        return nn.ModuleDict()
    raise ValueError(f"unknown deform_type {cfg.deform_type!r}")


def apply_deform_field(params, cfg: DeformConfig, xyz: torch.Tensor, t,
                       feature=None, motion_mask=None, step=10**9) -> dict:
    """-> dict(d_xyz, d_rotation, d_scaling, d_opacity, d_color) of the
    Gaussians at ``xyz`` at time ``t`` (DeformModel.step,
    scene/deform_model.py:41-44).  ``params``: the field's parameters
    (``init_deform``)."""
    n = xyz.shape[0]
    if cfg.deform_type == "node":
        mm = (motion_mask if motion_mask is not None
              else torch.ones((n, 1), dtype=torch.float32,
                              device=xyz.device))
        return warp(params, cfg.node, xyz, t, feature=feature,
                    motion_mask=mm, step=step)
    if cfg.deform_type == "mlp":
        tt = torch.as_tensor(t, dtype=torch.float32, device=xyz.device)
        tt = tt.reshape(1, 1).expand(n, 1) if tt.dim() == 0 else tt
        d = mlp_forward(params, cfg.mlp, xyz.detach(), tt, step=step)
    elif cfg.deform_type == "hash":
        d = hash_deform_forward(params, cfg.hash, xyz.detach(), t,
                                step=step)
    elif cfg.deform_type == "static":
        z = lambda c: torch.zeros((n, c), dtype=torch.float32,
                                  device=xyz.device)
        return {"d_xyz": z(3), "d_rotation": z(4), "d_scaling": z(2),
                "d_opacity": None, "d_color": None}
    else:
        raise ValueError(f"unknown deform_type {cfg.deform_type!r}")
    return {k: d.get(k) for k in ("d_xyz", "d_rotation", "d_scaling",
                                  "d_opacity", "d_color")}


def deform_gaussians(nodes: NodeParams, cfg: DeformConfig,
                     xyz: torch.Tensor, t, feature=None, motion_mask=None,
                     step=10**9) -> dict:
    """The trainer's, eval's and mesher's dispatch over the TrainState's
    one node slot: for the mlp and hash types, ``nodes.mlp`` holds the
    field's parameters (DeformModel.step); "static" reads no parameters,
    so ``nodes`` may be None."""
    params = nodes.mlp if cfg.deform_type in ("mlp", "hash") else nodes
    with trace.span("d2dgs.field"):
        trace.count("field.rows", xyz.shape[0])
        return apply_deform_field(params, cfg, xyz, t, feature=feature,
                                  motion_mask=motion_mask, step=step)
