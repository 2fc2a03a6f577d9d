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


# the per-row inputs, beside xyz, that apply_deform_field reads for a type
# (the GaussianParams attributes deform_gaussians gathers)
ROW_INPUTS = {"node": ("feature", "motion_mask"), "mlp": (), "hash": (),
              "static": ()}


def apply_deform_field(params, cfg: DeformConfig, xyz: torch.Tensor, t,
                       feature=None, motion_mask=None, step=10**9) -> dict:
    """-> dict(d_xyz, d_rotation, d_scaling, d_opacity, d_color) of the
    Gaussians at ``xyz`` at time ``t`` (DeformModel.step,
    scene/deform_model.py:41-44), at every row given.  ``params``: the
    field's parameters (``init_deform``); of the per-row inputs beside
    ``xyz``, a type reads those ``ROW_INPUTS`` names."""
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


# the last row list built: (alive mask, its version counter, the rows or
# None), replaced whole so that a reader sees one entry's three parts
_live = (None, -1, None)


def live_rows(alive: torch.Tensor):
    """The slots of the [C] bool mask ``alive`` that hold a live surfel,
    as int64 indices ([N_live]), or None where the field should run over
    every slot: none dead, or none alive.  Built once per mask and per
    write to it (``alive._version`` goes up on every in-place write:
    densify, a checkpoint load) with one host read, then reused: a step or
    a view on an unchanged mask reads nothing back."""
    global _live
    mask, version, rows = _live
    if mask is alive and version == alive._version:
        return rows
    trace.count("host.reads", 1)  # the count sizes the list
    trace.count("field.row_lists", 1)
    rows = torch.nonzero(alive).flatten()
    if rows.shape[0] in (0, alive.shape[0]):
        rows = None
    _live = (alive, alive._version, rows)
    return rows


def deform_gaussians(nodes: NodeParams, cfg: DeformConfig, gauss, t,
                     step=10**9) -> dict:
    """The field at the Gaussians ``gauss`` (a GaussianParams: ``xyz``,
    ``alive`` and the type's ``ROW_INPUTS``) at time ``t``, over the
    TrainState's one node slot: for the mlp and hash types, ``nodes.mlp``
    holds the field's parameters (DeformModel.step); "static" reads no
    parameters, so ``nodes`` may be None.

    The field runs on the live rows only (``live_rows``): its per-row
    inputs are gathered and its outputs scattered into [C, k] zeros, so a
    dead slot's deformation is 0 (every caller masks dead slots).  With
    no slot dead, every row is evaluated as ``apply_deform_field`` does
    (the JAX package's ``deform_gaussians``)."""
    params = nodes.mlp if cfg.deform_type in ("mlp", "hash") else nodes
    names = ROW_INPUTS.get(cfg.deform_type, ())
    with trace.span("d2dgs.field"):
        rows = live_rows(gauss.alive)
        if rows is None:
            trace.count("field.rows", gauss.xyz.shape[0])
            return apply_deform_field(
                params, cfg, gauss.xyz, t, step=step,
                **{k: getattr(gauss, k) for k in names})
        trace.count("field.rows", rows.shape[0])
        # index_select's backward adds onto distinct rows, deterministic
        # (advanced indexing's sorts); index_copy's is a gather
        d = apply_deform_field(
            params, cfg, torch.index_select(gauss.xyz.detach(), 0, rows), t,
            step=step, **{k: torch.index_select(getattr(gauss, k), 0, rows)
                          for k in names})
        n = gauss.xyz.shape[0]
        return {k: None if v is None else
                v.new_zeros((n,) + v.shape[1:]).index_copy(0, rows, v)
                for k, v in d.items()}
