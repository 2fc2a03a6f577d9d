"""Main-stage training step (counterpart of d2dgs_tpu/train/trainer.py, the
reference's train_step, train_gui.py:215-438).

One call of ``main_stage_step`` deforms the Gaussians at the camera's
time (node warp), renders them, takes the photometric and geometric
losses plus the node ARAP term, differentiates everything with one
``torch.autograd.grad`` (on CUDA tensors the blend's backward is the K2
kernel) and applies the three Adam groups.  Parameters and Adam moments
are updated in place; the returned state holds the same modules and
moment tensors with the new counts and densify statistics.

The node pre-training stage, densify/prune, opacity reset, node
downsampling, the ``Trainer`` loop and the data readers are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.cameras import Camera
from ..models import densify as D
from ..models import regularizers as R
from ..models.deform import deform_gaussians
from ..models.gaussians import GaussianParams, create_from_pcd
from ..models.nodes import NodeParams, init_node_params, init_nodes_from_pcl
from ..ops.ssim import l1, psnr, ssim
from ..render.renderer import render
from ..utils.general import get_expon_lr_func, resolve_device
from .config import TrainConfig
from .optim import AdamState, adam_init, adam_update

GAUSS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "feature")
NODE_FIELDS = ("nodes", "node_radius", "node_weight")


def gauss_trainable(p: GaussianParams) -> dict:
    return {k: getattr(p, k) for k in GAUSS_FIELDS}


def node_trainable(p: NodeParams) -> dict:
    return {k: getattr(p, k) for k in NODE_FIELDS}


def mlp_trainable(p: NodeParams) -> dict:
    """The deform MLP's parameters by name ("layers.0.w", "warp.b", ...)."""
    return dict(p.mlp.named_parameters())


class TrainState(NamedTuple):
    gauss: GaussianParams
    gauss_opt: AdamState
    gauss_stats: D.DensifyStats
    nodes: NodeParams
    node_opt: AdamState     # over node_trainable
    mlp_opt: AdamState      # over mlp_trainable
    generator: torch.Generator   # the random draws of the steps (CPU)
    # stage-1 isotropic node-Gaussians, their optimizer and stats
    ngauss: GaussianParams | None = None
    ngauss_opt: AdamState | None = None
    ngauss_stats: D.DensifyStats | None = None


def gauss_lr_tree(cfg: TrainConfig, xyz_lr) -> dict:
    """Per-group LRs (gaussian_model.py training_setup:189-201)."""
    return dict(
        xyz=xyz_lr,
        features_dc=cfg.feature_lr,
        features_rest=cfg.feature_lr / 20.0,
        scaling=cfg.scaling_lr * cfg.spatial_lr_scale,
        rotation=cfg.rotation_lr,
        opacity=cfg.opacity_lr,
        feature=cfg.feature_lr,
    )


def make_schedules(cfg: TrainConfig):
    xyz_sched = get_expon_lr_func(
        lr_init=cfg.position_lr_init * cfg.spatial_lr_scale,
        lr_final=cfg.position_lr_final * cfg.spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps)
    deform_sched = get_expon_lr_func(
        lr_init=cfg.deform_lr_init, lr_final=cfg.deform_lr_final,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.deform_lr_max_steps)
    return xyz_sched, deform_sched


def init_train_state(cfg: TrainConfig, init_points: np.ndarray,
                     init_colors: np.ndarray,
                     generator: torch.Generator | None = None,
                     device="cuda") -> TrainState:
    """All model state from the scene's initial point cloud
    (GUI.__init__, train_gui.py:147-170).  Random draws (the MLP weights,
    the FPS start of the nodes, the later steps' draws) come from
    ``generator`` (default: seed 0)."""
    if cfg.deform_type != "node":
        raise NotImplementedError(
            f"deform_type {cfg.deform_type!r}: only the node type is "
            f"ported to training (ROADMAP.md)")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0) if generator is None \
        else generator
    gauss = create_from_pcd(init_points, init_colors, cfg.gaussian_capacity,
                            sh_degree=cfg.sh_degree, fea_dim=cfg.hyper_dim,
                            with_motion_mask=True, device=dev)
    nodes = init_node_params(cfg.node_cfg, gen, device=dev)
    init_nodes_from_pcl(nodes, cfg.node_cfg,
                        torch.as_tensor(np.asarray(init_points, np.float32)),
                        generator=gen)
    # stage-1 isotropic Gaussians on the node positions (init_gaussians,
    # time_utils.py:1258-1266: SH degree 0, colours 0.5)
    node_xyz = nodes.nodes[:, :3].detach().cpu().numpy()
    ngauss = create_from_pcd(
        node_xyz, np.full_like(node_xyz, 0.5), cfg.node_gauss_capacity,
        sh_degree=0, fea_dim=0,
        with_motion_mask=cfg.gt_alpha_mask_as_dynamic_mask, isotropic=True,
        device=dev)
    return TrainState(
        gauss=gauss, gauss_opt=adam_init(gauss_trainable(gauss)),
        gauss_stats=D.init_stats(cfg.gaussian_capacity, dev),
        nodes=nodes, node_opt=adam_init(node_trainable(nodes)),
        mlp_opt=adam_init(mlp_trainable(nodes)), generator=gen,
        ngauss=ngauss, ngauss_opt=adam_init(gauss_trainable(ngauss)),
        ngauss_stats=D.init_stats(cfg.node_gauss_capacity, dev))


def photometric_loss(gauss: GaussianParams, nodes: NodeParams, cam: Camera,
                     gt: torch.Tensor, probe, cfg: TrainConfig, sched: dict,
                     bg: torch.Tensor):
    """Per-camera photometric + geometric losses of the main stage
    (train_gui.py:286-313): deform at cam.time, render, L1+D-SSIM,
    normal-consistency and distortion terms.  Before the warm-up ends
    (``sched["warm"]`` 1) the deformation passes no gradient.
    Returns (loss, (RenderOutput, l1))."""
    d = deform_gaussians(nodes, cfg.deform_cfg, gauss.xyz, cam.time,
                         feature=gauss.feature,
                         motion_mask=gauss.motion_mask,
                         step=sched.get("step", 10**9))
    w = sched["warm"]

    def gate(x):
        return None if x is None else x.detach() * w + x * (1.0 - w)

    out = render(cam, gauss, bg, d_xyz=gate(d["d_xyz"]),
                 d_rotation=gate(d["d_rotation"]),
                 d_scaling=gate(d["d_scaling"]),
                 d_opacity=gate(d["d_opacity"]),
                 d_color=gate(d["d_color"]),
                 screen_probe=probe, cfg=cfg.raster)
    ll1 = l1(out.image, gt)
    loss = ((1.0 - cfg.lambda_dssim) * ll1
            + cfg.lambda_dssim * (1.0 - ssim(out.image, gt)))
    # normal consistency + distortion (train_gui.py:292-299)
    normal_err = 1.0 - torch.sum(out.rend_normal * out.surf_normal, dim=-1)
    loss = loss + sched["lambda_normal"] * torch.mean(normal_err)
    loss = loss + sched["lambda_dist"] * torch.mean(out.rend_dist)
    return loss, (out, ll1)


def main_stage_step(state: TrainState, cam: Camera, gt: torch.Tensor,
                    cfg: TrainConfig, sched: dict, gt_alpha=None,
                    motion_loss: bool = False, flow_sample=None,
                    flow_loss: bool = False,
                    arap_draws: R.ArapDraws | None = None):
    """sched: warm (0/1: iter < warm_up), lambda_normal, lambda_dist,
    lambda_arap, deform_lr, xyz_lr (and optionally step).  The ARAP
    term's random numbers are ``arap_draws``, or drawn from
    ``state.generator``.  Returns (state, metrics)."""
    if motion_loss or flow_loss:
        raise NotImplementedError(
            "the motion-mask and optical-flow losses need the 3DGS flow "
            "rasterizer and alpha masks, which are not ported yet "
            "(ROADMAP.md)")
    dev = state.gauss.xyz.device
    bg = (1.0 if cfg.white_background else 0.0) * torch.ones(3, device=dev)
    groups = [gauss_trainable(state.gauss), mlp_trainable(state.nodes),
              node_trainable(state.nodes)]
    probe = torch.zeros((state.gauss.capacity, 2), device=dev,
                        requires_grad=True)
    alive = state.gauss.num_alive

    loss, (out, ll1) = photometric_loss(state.gauss, state.nodes, cam, gt,
                                        probe, cfg, sched, bg)
    # deform ARAP reg (time_utils.py:1228-1232), gated by the warm-up;
    # node-graph-specific: other deform types have no node graph
    if cfg.deform_type == "node":
        if arap_draws is None:
            arap_draws = R.arap_draws(state.generator,
                                      state.nodes.nodes.shape[0])
        loss = loss + (1.0 - sched["warm"]) * sched["lambda_arap"] * \
            R.arap_loss(state.nodes, cfg.node_cfg, arap_draws)

    inputs = [p for g in groups for p in g.values()] + [probe]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    named, i = [], 0
    for g in groups:
        named.append(dict(zip(g, grads[i:i + len(g)])))
        i += len(g)
    g_gauss, g_mlp, g_node = named
    g_probe = grads[-1]

    gauss_opt = adam_update(g_gauss, state.gauss_opt, groups[0],
                            gauss_lr_tree(cfg, sched["xyz_lr"]))
    mlp_opt = adam_update(g_mlp, state.mlp_opt, groups[1],
                          sched["deform_lr"])
    node_opt = adam_update(g_node, state.node_opt, groups[2],
                           cfg.deform_lr_init)
    if g_probe is None:
        g_probe = torch.zeros_like(probe)
    stats = D.add_stats(state.gauss_stats, g_probe, out.visibility,
                        out.radii.to(torch.float32))
    metrics = dict(loss=ll1.detach(), psnr=psnr(out.image.detach(), gt),
                   num_pairs=out.num_pairs, overflow=out.overflow,
                   alive=alive)
    return state._replace(gauss_opt=gauss_opt, mlp_opt=mlp_opt,
                          node_opt=node_opt, gauss_stats=stats), metrics
