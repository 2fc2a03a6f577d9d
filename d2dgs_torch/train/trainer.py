"""Two-stage trainer (counterpart of d2dgs_tpu/train/trainer.py, the
reference's GUI.train / train_node_rendering_step / train_step,
train_gui.py:132-599): the step functions and the host loop ``Trainer``.

One call of ``node_stage_step`` (stage 1) or ``main_stage_step`` (stage 2)
deforms the Gaussians at the camera's time, renders them, takes the
losses and regularizers, differentiates everything with one
``torch.autograd.grad`` (on CUDA tensors the blend's backward is K2 or
K4, the blend kernels' backward) and applies the three Adam groups.
Densify/prune, opacity reset, node downsampling and node densification
run on the reference's schedule from the host loop.  Parameters, the
``alive`` masks and Adam moments are updated in place (the JAX package's
steps are pure); each step returns the state with the new counts,
moments and densify statistics.  PyTorch runs eagerly, so the JAX
trainer's ``precompile`` has no counterpart.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..data.cameras import Camera
from ..models import densify as D
from ..models import regularizers as R
from ..models.deform import deform_gaussians, init_deform
from ..models.deform_mlp import mlp_forward
from ..models.gaussians import GaussianParams, create_from_pcd
from ..models.nodes import (NodeParams, densify_nodes, init_node_params,
                            init_nodes_from_pcl)
from ..ops.ssim import l1, psnr, ssim
from ..render.renderer import render, render_flow
from ..utils.general import (farthest_point_sample, get_expon_lr_func,
                             get_linear_noise_func, resolve_device)
from .config import TrainConfig
from .optim import AdamState, adam_init, adam_update

GAUSS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "feature")
NODE_FIELDS = ("nodes", "node_radius", "node_weight")


def gauss_trainable(p: GaussianParams) -> dict:
    return {k: getattr(p, k) for k in GAUSS_FIELDS}


def with_trainable(p: GaussianParams, t: dict) -> GaussianParams:
    """Gaussians like ``p`` whose trainable leaves are ``t`` (names of
    GAUSS_FIELDS; the leaves not named stay ``p``'s), sharing their
    storage: the JAX package's functional update (the port's steps update
    in place)."""
    return GaussianParams(
        **{k: t.get(k, getattr(p, k)).detach() for k in GAUSS_FIELDS},
        alive=p.alive, active_sh_degree=p.active_sh_degree,
        with_motion_mask=p.with_motion_mask,
        isotropic_shared_scale=p.isotropic_shared_scale)


def node_trainable(p: NodeParams) -> dict:
    return {k: getattr(p, k) for k in NODE_FIELDS}


def with_node_trainable(p: NodeParams, t: dict, mlp) -> NodeParams:
    """Nodes like ``p`` with the node leaves ``t`` (NODE_FIELDS) and the
    deform field ``mlp``: a module, or its parameters by name
    (``mlp_trainable``'s form), which then fill a copy of ``p.mlp``."""
    if not isinstance(mlp, torch.nn.Module):
        values, mlp = mlp, copy.deepcopy(p.mlp)
        for k, prm in mlp.named_parameters():
            prm.data = values[k].detach()
    return NodeParams(**{k: t.get(k, getattr(p, k)).detach()
                         for k in NODE_FIELDS}, mlp=mlp, alive=p.alive)


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
    ``generator`` (default: seed 0).  The nodes are built from the point
    cloud for every deform type; for "mlp", "hash" and "static" the
    field's parameters then take the place of ``nodes.mlp``
    (models/deform.py ``deform_gaussians``), drawn after the nodes'."""
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
    if cfg.deform_type != "node":
        nodes.mlp = init_deform(cfg.deform_cfg, gen, dev)
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
        mlp_opt=adam_init(mlp_trainable(nodes), device=dev), generator=gen,
        ngauss=ngauss, ngauss_opt=adam_init(gauss_trainable(ngauss)),
        ngauss_stats=D.init_stats(cfg.node_gauss_capacity, dev))


def _detached(g: GaussianParams) -> GaussianParams:
    """The Gaussians' values as a module whose parameters take no
    gradient."""
    d = GaussianParams(
        **{k: getattr(g, k).detach() for k in GAUSS_FIELDS}, alive=g.alive,
        active_sh_degree=g.active_sh_degree,
        with_motion_mask=g.with_motion_mask,
        isotropic_shared_scale=g.isotropic_shared_scale)
    return d.requires_grad_(False)


def motion_mask_loss(gauss: GaussianParams, cam: Camera,
                     gt_alpha: torch.Tensor, bg: torch.Tensor,
                     cfg: TrainConfig, d: dict | None = None):
    """Motion-mask supervision (train_gui.py:363-370 / 509-515, render_motion
    at gaussian_renderer/__init__.py:103-107): a render with the override
    colours [mask, 0, 1 - mask] on detached geometry (and detached
    deformation ``d``), L1 of channel 0 against the gt alpha mask.  Its
    gradient reaches only the motion-mask logits."""
    mm = gauss.motion_mask
    override = torch.cat([mm, torch.zeros_like(mm), 1.0 - mm], dim=-1)
    kw = {}
    if d is not None:
        for k in ("d_xyz", "d_rotation", "d_scaling"):
            if d.get(k) is not None:
                kw[k] = d[k].detach()
    out = render(cam, _detached(gauss), bg, override_color=override,
                 cfg=cfg.raster, **kw)
    return l1(out.image[..., 0], gt_alpha[..., 0])


def photometric_loss(gauss: GaussianParams, nodes: NodeParams, cam: Camera,
                     gt: torch.Tensor, probe, cfg: TrainConfig, sched: dict,
                     bg: torch.Tensor):
    """Per-camera photometric + geometric losses of the main stage
    (train_gui.py:286-313): deform at cam.time, render, L1+D-SSIM,
    normal-consistency and distortion terms.  Before the warm-up ends
    (``sched["warm"]`` 1) the deformation passes no gradient.
    Returns (loss, (RenderOutput, l1))."""
    d = deform_gaussians(nodes, cfg.deform_cfg, gauss, cam.time,
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
    with trace.span("d2dgs.loss"):
        ll1 = l1(out.image, gt)
        loss = ((1.0 - cfg.lambda_dssim) * ll1
                + cfg.lambda_dssim * (1.0 - ssim(out.image, gt)))
        # normal consistency + distortion (train_gui.py:292-299)
        normal_err = 1.0 - torch.sum(out.rend_normal * out.surf_normal,
                                     dim=-1)
        loss = loss + sched["lambda_normal"] * torch.mean(normal_err)
        loss = loss + sched["lambda_dist"] * torch.mean(out.rend_dist)
    return loss, (out, ll1)


def optical_flow_loss(gauss: GaussianParams, nodes: NodeParams, cam: Camera,
                      cam2: Camera, gt_flow: torch.Tensor,
                      flow_mask: torch.Tensor, pair_weight,
                      image: torch.Tensor, gt: torch.Tensor,
                      cfg: TrainConfig, sched: dict):
    """Optical-flow supervision (train_gui.py:318-361): the per-pixel uv
    motion between (cam, t1) and (cam2, t2), rendered by the 3DGS flow
    rasterizer, L1 against the normalised RAFT flow, masked by solid
    alpha (> 0.9), the RAFT mask, the time proximity ``pair_weight`` and
    the photometric confidence cos(pi/2 |image - gt|)."""
    step = sched.get("step", 10**9)
    d1 = deform_gaussians(nodes, cfg.deform_cfg, gauss, cam.time, step=step)
    d2 = deform_gaussians(nodes, cfg.deform_cfg, gauss, cam2.time, step=step)
    f = render_flow(gauss, cam, cam2, d_xyz1=d1["d_xyz"],
                    d_xyz2=d2["d_xyz"], d_rotation1=d1["d_rotation"],
                    d_scaling1=d1["d_scaling"], cfg=cfg.raster)
    coor_motion = f["render"][..., :2]                     # [H,W,2]
    mask_motion = (f["alpha"][..., 0] > 0.9).to(torch.float32)
    mask = (mask_motion * flow_mask[..., 0])[..., None] * pair_weight
    # photometric-confidence weight (train_gui.py:355-358)
    l1w = torch.cos(torch.mean(torch.abs(image.detach() - gt), dim=-1)
                    * math.pi / 2.0)
    mask = mask * l1w[..., None]
    return l1(mask * gt_flow, mask * coor_motion)


def _grads_and_adam(loss, groups, probe, opts, lrs):
    """One ``torch.autograd.grad`` over the three parameter groups and the
    screen probe, then Adam on each group in place.  Returns (the three
    new AdamStates, the probe's gradient)."""
    inputs = [p for g in groups for p in g.values()] + [probe]
    # a view where nothing is drawn leaves the loss a constant of the
    # background on the plain path: every gradient is zero, as in JAX
    with trace.span("d2dgs.backward"):
        grads = (torch.autograd.grad(loss, inputs, allow_unused=True)
                 if loss.requires_grad else [None] * len(inputs))
    with trace.span("d2dgs.adam"):
        new, i = [], 0
        for g, opt, lr in zip(groups, opts, lrs):
            new.append(adam_update(dict(zip(g, grads[i:i + len(g)])), opt,
                                   g, lr))
            i += len(g)
        g_probe = (grads[-1] if grads[-1] is not None
                   else torch.zeros_like(probe))
    return new, g_probe


def node_stage_step(state: TrainState, cam: Camera, gt: torch.Tensor,
                    cfg: TrainConfig, sched: dict, gt_alpha=None,
                    motion_loss: bool = False,
                    arap_draws: R.ArapDraws | None = None,
                    elastic_draws: R.TimeDraws | None = None,
                    acc_draws: R.TimeDraws | None = None):
    """Stage 1 (train_node_rendering_step, train_gui.py:441-599): the
    isotropic node Gaussians warped by the deform MLP, rendered, L1 +
    D-SSIM, plus (when ``sched["reg_on"]`` is 1) the elastic,
    acceleration and ARAP terms of the node graph.  sched: warm (0/1:
    iter < node_warm_up; the warp is detached), reg_on (0/1), deform_lr,
    xyz_lr, time_interval (and optionally step).  The regularizers' random
    numbers are the ``*_draws`` arguments, or drawn from
    ``state.generator``.  With ``motion_loss`` the motion-mask term
    (weight ``sched["reg_on"]``) pulls the node Gaussians' motion-mask
    logits towards ``gt_alpha``.  Returns (state, metrics)."""
    ng, nodes = state.ngauss, state.nodes
    dev = ng.xyz.device
    bg = (1.0 if cfg.white_background else 0.0) * torch.ones(3, device=dev)
    groups = [gauss_trainable(ng), mlp_trainable(nodes),
              node_trainable(nodes)]
    probe = torch.zeros((ng.capacity, 2), device=dev, requires_grad=True)
    gen, m = state.generator, nodes.nodes.shape[0]
    if arap_draws is None:
        arap_draws = R.arap_draws(gen, m)
    if elastic_draws is None:
        elastic_draws = R.time_draws(gen, 8)
    if acc_draws is None:
        acc_draws = R.time_draws(gen)

    t = cam.time.reshape(1, 1).expand(ng.capacity, 1)
    with trace.span("d2dgs.field"):
        trace.count("field.rows", ng.capacity)
        d_xyz = mlp_forward(nodes.mlp, cfg.node_cfg.mlp, ng.xyz.detach(), t,
                            step=sched.get("step", 10**9))["d_xyz"]
        d_xyz = d_xyz * ng.motion_mask
    # before node_warm_up the warp is detached (train_gui.py:482-483)
    w = sched["warm"]
    d_xyz = d_xyz.detach() * w + d_xyz * (1.0 - w)
    out = render(cam, ng, bg, d_xyz=d_xyz, screen_probe=probe,
                 cfg=cfg.raster)
    with trace.span("d2dgs.loss"):
        ll1 = l1(out.image, gt)
        loss = ((1.0 - cfg.lambda_dssim) * ll1
                + cfg.lambda_dssim * (1.0 - ssim(out.image, gt)))
    if motion_loss:
        # stage-1 motion-mask loss, weight 1 (train_gui.py:509-515)
        loss = loss + sched["reg_on"] * motion_mask_loss(
            ng, cam, gt_alpha, bg, cfg, d={"d_xyz": d_xyz})
    with trace.span("d2dgs.loss"):
        reg = (cfg.lambda_elastic * R.elastic_loss(
                   nodes, cfg.node_cfg, elastic_draws, t=cam.time,
                   delta_t=sched["time_interval"])
               + cfg.lambda_acc * R.acc_loss(
                   nodes, cfg.node_cfg, acc_draws, t=cam.time,
                   delta_t=3.0 * sched["time_interval"]))
        if not cfg.no_arap_loss:
            reg = reg + cfg.lambda_node_arap * R.arap_loss(
                nodes, cfg.node_cfg, arap_draws)
        loss = loss + sched["reg_on"] * reg

    (ngauss_opt, mlp_opt, node_opt), g_probe = _grads_and_adam(
        loss, groups, probe, (state.ngauss_opt, state.mlp_opt,
                              state.node_opt),
        (gauss_lr_tree(cfg, sched["xyz_lr"]), sched["deform_lr"],
         cfg.deform_lr_init))
    with trace.span("d2dgs.adam"):
        stats = D.add_stats(state.ngauss_stats, g_probe, out.visibility,
                            out.radii.to(torch.float32))
    metrics = dict(loss=ll1.detach(), psnr=psnr(out.image.detach(), gt),
                   num_pairs=out.num_pairs, overflow=out.overflow)
    return state._replace(ngauss_opt=ngauss_opt, mlp_opt=mlp_opt,
                          node_opt=node_opt, ngauss_stats=stats), metrics


def main_stage_step(state: TrainState, cam: Camera, gt: torch.Tensor,
                    cfg: TrainConfig, sched: dict, gt_alpha=None,
                    motion_loss: bool = False, flow_sample=None,
                    flow_loss: bool = False,
                    arap_draws: R.ArapDraws | None = None):
    """sched: warm (0/1: iter < warm_up), lambda_normal, lambda_dist,
    lambda_arap, deform_lr, xyz_lr (and optionally step; lambda_motion
    with ``motion_loss``, lambda_optical with ``flow_loss``).
    flow_sample: (cam2, gt_flow [H,W,2], flow_mask [H,W,1],
    pair_weight).  The ARAP term's random numbers are ``arap_draws``, or
    drawn from ``state.generator``.  Returns (state, metrics)."""
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
        with trace.span("d2dgs.loss"):
            if arap_draws is None:
                arap_draws = R.arap_draws(state.generator,
                                          state.nodes.nodes.shape[0])
            loss = loss + (1.0 - sched["warm"]) * sched["lambda_arap"] * \
                R.arap_loss(state.nodes, cfg.node_cfg, arap_draws)
    if motion_loss:
        # motion-mask loss (train_gui.py:363-370), landmark-scheduled; its
        # render takes the deformation detached, so it is built without a
        # graph
        g = state.gauss
        with torch.no_grad():
            d = deform_gaussians(state.nodes, cfg.deform_cfg, g, cam.time,
                                 step=sched.get("step", 10**9))
        loss = loss + sched["lambda_motion"] * motion_mask_loss(
            g, cam, gt_alpha, bg, cfg, d=d)
    if flow_loss:
        cam2, gt_flow, flow_mask, pair_weight = flow_sample
        loss = loss + sched["lambda_optical"] * optical_flow_loss(
            state.gauss, state.nodes, cam, cam2, gt_flow, flow_mask,
            pair_weight, out.image, gt, cfg, sched)

    (gauss_opt, mlp_opt, node_opt), g_probe = _grads_and_adam(
        loss, groups, probe, (state.gauss_opt, state.mlp_opt,
                              state.node_opt),
        (gauss_lr_tree(cfg, sched["xyz_lr"]), sched["deform_lr"],
         cfg.deform_lr_init))
    with trace.span("d2dgs.adam"):
        stats = D.add_stats(state.gauss_stats, g_probe, out.visibility,
                            out.radii.to(torch.float32))
    metrics = dict(loss=ll1.detach(), psnr=psnr(out.image.detach(), gt),
                   num_pairs=out.num_pairs, overflow=out.overflow,
                   alive=alive)
    return state._replace(gauss_opt=gauss_opt, mlp_opt=mlp_opt,
                          node_opt=node_opt, gauss_stats=stats), metrics


# ----------------------------------------------------------------------
# Densify / maintenance steps
# ----------------------------------------------------------------------

def densify_step(state: TrainState, cfg: TrainConfig, which: str, extent,
                 min_opacity, prune_big_ws, grad_max,
                 noise: torch.Tensor | None = None):
    """Densify and prune the main (``which`` "main") or the stage-1 node
    Gaussians, in place.  ``noise`` [2, C, 2]: the split offsets, or drawn
    from ``state.generator``.  Returns (state, info)."""
    main = which == "main"
    p, opt, stats = ((state.gauss, state.gauss_opt, state.gauss_stats)
                     if main else
                     (state.ngauss, state.ngauss_opt, state.ngauss_stats))
    stats2, info = D.densify_and_prune(
        p, opt.mu, opt.nu, stats, grad_max, min_opacity, extent,
        prune_big_ws, percent_dense=cfg.percent_dense, noise=noise,
        generator=state.generator)
    if main:
        return state._replace(gauss_stats=stats2), info
    return state._replace(ngauss_stats=stats2), info


def reset_opacity_step(state: TrainState, which: str = "main"):
    """Opacity ceiling 0.01 and zeroed opacity moments, in place."""
    p, opt = ((state.gauss, state.gauss_opt) if which == "main"
              else (state.ngauss, state.ngauss_opt))
    D.reset_opacity(p, opt.mu, opt.nu, ceiling=0.01)
    return state


@torch.no_grad()
def node_downsample_step(state: TrainState, cfg: TrainConfig,
                         fps_start: int | None = None):
    """Stage-1 downsampling (train_gui.py:556-583): deform the live node
    Gaussians at 16 times, farthest-point-sample ``node_num`` of them in
    that trajectory space, and rebuild the nodes and the node Gaussians
    from the selected subset, with fresh Adam moments and statistics.
    ``fps_start``: the sample's first index, or drawn from
    ``state.generator`` among the live node Gaussians."""
    ng, nodes = state.ngauss, state.nodes
    dev = ng.xyz.device
    m_cap, node_num = ng.capacity, cfg.node_num
    x = ng.xyz.detach()
    t_samp = torch.linspace(0.0, 1.0, 16, device=dev)
    tt = t_samp[None, :, None].expand(m_cap, 16, 1)
    xx = x[:, None, :].expand(m_cap, 16, 3)
    d_xyz = mlp_forward(nodes.mlp, cfg.node_cfg.mlp, xx, tt)["d_xyz"]
    d_xyz = d_xyz * ng.motion_mask[:, None, :]
    hyper_pcl = (d_xyz + x[:, None, :]).reshape(m_cap, -1)
    idx = farthest_point_sample(hyper_pcl, node_num, generator=state.generator,
                                start=fps_start, mask=ng.alive).long()

    alive = ng.alive[:, None]
    scene_range = (torch.max(torch.where(alive, x, float("-inf")))
                   - torch.min(torch.where(alive, x, float("inf"))))
    nodes.nodes.copy_(torch.cat(
        [x[idx], 1e-2 * torch.ones((node_num, cfg.hyper_dim), device=dev)],
        dim=-1))
    nodes.node_radius.copy_(torch.log(0.1 * scene_range + 1e-7)
                            * torch.ones(node_num, device=dev))
    nodes.node_weight.zero_()
    nodes.alive.fill_(True)

    # shrink the node Gaussians to the selected subset; dead slots keep
    # an identity quaternion (an all-zero one has no normalisation)
    for name in GAUSS_FIELDS:
        a = getattr(ng, name)
        sel = a[idx]
        a.zero_()
        if name == "rotation":
            a[:, 0] = 1.0
        a[:node_num] = sel
    ng.alive.zero_()
    ng.alive[:node_num] = True
    return state._replace(
        node_opt=adam_init(node_trainable(nodes)),
        ngauss_opt=adam_init(gauss_trainable(ng)),
        ngauss_stats=D.init_stats(m_cap, dev))


@torch.no_grad()
def adopt_node_positions(state: TrainState):
    """End of stage 1: the nodes' xyz become the node Gaussians'
    (train_gui.py:581-583)."""
    node_num = state.nodes.nodes.shape[0]
    state.nodes.nodes[:, :3] = state.ngauss.xyz[:node_num]
    return state


def node_densify_step(state: TrainState, cfg: TrainConfig, grad_max):
    """Node densify/prune by Gaussian-importance voting (force-run at
    node_force_densify_prune_step, train_gui.py:413-415).  Returns
    (state, info)."""
    st = state.gauss_stats
    g = torch.where(st.denom > 0, st.grad_accum / st.denom, 0.0)
    info = densify_nodes(state.nodes, cfg.node_cfg, state.node_opt.mu,
                         state.node_opt.nu, state.gauss.xyz.detach(),
                         g[:, None], state.gauss.feature.detach(), grad_max,
                         state.gauss.alive)
    return state, info


def oneup_sh(state: TrainState, cfg: TrainConfig):
    state.gauss.oneup_sh_degree()
    return state


# ----------------------------------------------------------------------
# Host-side training loop
# ----------------------------------------------------------------------

class Trainer:
    """Host orchestration: camera sampling, schedules, stage transitions
    (the JAX package's ``Trainer``, step for step).  Camera picks use
    ``np.random.RandomState(seed)`` as the JAX trainer does, so both pick
    the same cameras; model draws come from the state's
    ``torch.Generator``.  ``precompile`` has no counterpart (PyTorch runs
    eagerly).  ``enable_sharded_training`` runs the main stage on a (data
    x gauss) rank grid (d2dgs_torch/parallel/): every rank builds the same
    Trainer from the same seed, then holds its shard of the Gaussians;
    ``full_state`` gathers them.  ``attach_viewer`` serves SIBR viewer
    frames at the top of each step."""

    def __init__(self, cfg: TrainConfig, cameras, images,
                 init_points, init_colors, cameras_extent: float = 5.0,
                 seed: int = 0, log_fn=None, alphas=None,
                 flow_dirs=None, image_names=None, device="cuda"):
        """cameras: list[Camera] on ``device``; images: list of [H,W,3]
        float arrays or tensors; alphas: optional list of [H,W,1] gt alpha
        masks (the motion-mask loss when
        ``cfg.gt_alpha_mask_as_dynamic_mask``); flow_dirs: optional
        per-camera candidate RAFT flow files (``data/flow.find_flow_dirs``)
        and image_names, which resolve a flow file's target frame: the
        optical-flow loss."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cameras = cameras
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
        self.images = [as_t(im) for im in images]
        self.alphas = (None if alphas is None else
                       [None if a is None else as_t(a) for a in alphas])
        self.flow_dirs = flow_dirs
        self._name2idx = ({} if image_names is None else
                          {os.path.splitext(n)[0]: i
                           for i, n in enumerate(image_names)})
        self._times = [float(c.time) for c in cameras]
        self.extent = float(cameras_extent)
        self.state = init_train_state(
            cfg, init_points, init_colors,
            torch.Generator().manual_seed(seed), device=self.device)
        self.xyz_sched, self.deform_sched = make_schedules(cfg)
        self.iteration = 1
        # the node pre-training stage is ControlNodeWarp-specific
        # (train_gui.py:207-213)
        self.iteration_node = (1 if cfg.deform_type == "node"
                               else cfg.iterations_node_rendering)
        self.rng = np.random.RandomState(seed)
        self._stack = []
        self.log_fn = log_fn or (lambda *a, **k: None)
        self.time_interval = 1.0 / max(len(cameras), 1)
        # time-noise magnitude schedule (train_gui.py:189)
        self.smooth_term = get_linear_noise_func(
            lr_init=0.1, lr_final=1e-15, lr_delay_mult=0.01,
            max_steps=20_000)
        self._time_order = np.argsort(self._times).tolist()
        # optional SIBR remote viewer (network_gui poll at the top of each
        # train step, train_gui.py:216-229); attach via attach_viewer()
        self.viewer = None
        # optional sharded main stage (enable_sharded_training)
        self._sharded_step = None
        self._mesh = None
        self._sharded_motion = False

    def enable_sharded_training(self, mesh_shape, exchange_cap=None):
        """Run the main stage on a (data x gauss) rank grid with the
        tile-binning exchange (parallel/gauss_train.py): each step takes
        mesh_shape[0] cameras, their gradients averaged into one Adam
        update, the densify statistics per view.  Every rank of a process
        group of mesh_shape[0] * mesh_shape[1] ranks (none for 1 x 1)
        calls it on its identical Trainer; it then holds its shard.  The
        node stage stays replicated.  ``exchange_cap`` None sizes the
        exchange from the measured per-destination record counts of a
        few cameras, with a margin of 2."""
        from ..parallel import (make_mesh2d, make_sharded_train_step,
                                shard_gauss_state, suggest_exchange_cap)
        from ..utils.quaternion import quat_normalize
        n_data, n_gauss = mesh_shape
        mesh = make_mesh2d(n_data, n_gauss)
        self.state = shard_gauss_state(mesh, self.state)
        if exchange_cap is None:
            g = self.state.gauss
            sample = [self.cameras[i] for i in
                      range(0, len(self.cameras),
                            max(len(self.cameras) // 4, 1))][:4]
            with torch.no_grad():
                exchange_cap = suggest_exchange_cap(
                    mesh.gauss_group, sample, g.xyz, g.get_scaling,
                    quat_normalize(g.rotation, eps=1e-12), g.alive,
                    self.cfg.raster, margin=2.0)
            self.log_fn({"exchange_cap": exchange_cap})
        self._sharded_motion = (self.alphas is not None
                                and self.cfg.gt_alpha_mask_as_dynamic_mask
                                and not self.cfg.no_motion_mask_loss)
        self._sharded_step = make_sharded_train_step(
            mesh, self.cfg, exchange_cap=exchange_cap,
            motion_loss=self._sharded_motion)
        self._mesh = mesh
        self.exchange_cap = exchange_cap
        return mesh

    def full_state(self) -> TrainState:
        """The whole state: with sharded training, gathered from every
        rank's shard (a collective: every rank calls it)."""
        if self._mesh is None:
            return self.state
        from ..parallel import gather_gauss_state
        return gather_gauss_state(self._mesh, self.state)

    def attach_viewer(self, host: str = "127.0.0.1", port: int = 6009):
        if self._mesh is not None:
            raise ValueError("the viewer renders the whole state: attach it "
                             "to a Trainer that is not sharded")
        from ..viewer import ViewerServer
        self.viewer = ViewerServer(host, port, device=self.device)
        return self.viewer

    def _poll_viewer(self):
        if self.viewer is None:
            return

        def render_fn(cam, scaling_modifier):
            g = self.state.gauss
            d = deform_gaussians(self.state.nodes, self.cfg.deform_cfg, g,
                                 cam.time)
            out = render(cam, g, torch.zeros(3, device=self.device),
                         d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                         d_scaling=d["d_scaling"],
                         scaling_modifier=scaling_modifier,
                         cfg=self.cfg.raster)
            return out.image

        # serve frames until the client hands control back to training
        while True:
            st = self.viewer.poll(render_fn)
            if not st["connected"] or st["do_training"]:
                break

    def _refill_stack(self):
        """Progressive time-window curriculum (train_gui.py:238-253)."""
        cfg, it, n = self.cfg, self.iteration, len(self.cameras)
        if (cfg.progressive_train and it < int(
                cfg.progressive_stage_steps / cfg.progressive_stage_ratio)):
            hi = int(min((it / cfg.progressive_stage_steps + 1)
                         * cfg.progressive_stage_ratio, 1.0) * n)
            hi = max(hi, 1)
            win = int(n * cfg.progressive_stage_ratio)
            lo = max(0, hi - win)
            stack = self._time_order[lo:hi]
            replay = self._time_order[:lo]
            if len(replay) >= win:
                stack = stack + [replay[j] for j in self.rng.choice(
                    len(replay), win, replace=False)]
            self._stack = stack
        else:
            self._stack = list(range(n))

    def sampler_state(self) -> dict:
        """The camera sampler's state (its ``RandomState`` and the cameras
        left in this pass) as JSON values, for a run that resumes."""
        _, keys, pos, has_gauss, cached = self.rng.get_state()
        return {"keys": keys.tolist(), "pos": int(pos),
                "has_gauss": int(has_gauss), "cached": float(cached),
                "stack": list(self._stack)}

    def set_sampler_state(self, s: dict) -> None:
        """Restores what ``sampler_state`` returned."""
        self.rng.set_state(("MT19937", np.asarray(s["keys"], np.uint32),
                            s["pos"], s["has_gauss"], s["cached"]))
        self._stack = list(s["stack"])

    def _pick_camera(self):
        with trace.span("d2dgs.pick"):
            if not self._stack:
                self._refill_stack()
            i = self._stack.pop(self.rng.randint(len(self._stack)))
            cam, img = self.cameras[i], self.images[i]
            if not self.cfg.is_blender:
                # time noise on the deformation query (train_gui.py:278)
                noise = (self.rng.randn() * self.time_interval
                         * self.smooth_term(self.iteration))
                trace.count("host.reads", 1)  # a copy from host memory
                cam = dataclasses.replace(
                    cam, time=cam.time + torch.tensor(
                        noise, dtype=torch.float32, device=cam.device))
            alpha = None if self.alphas is None else self.alphas[i]
            self._last_cam_idx = i
            return cam, img, alpha

    def _pick_flow_sample(self, cam_idx: int):
        """A random RAFT flow candidate of the picked camera, loaded, with
        its target camera (train_gui.py:321-338), drawn from ``self.rng``
        as the JAX trainer draws it.  Returns (cam2, gt_flow, flow_mask,
        pair_weight), or None where the camera has no candidate, the
        target frame is not a training image, or the file cannot be
        read."""
        if not self.flow_dirs or not self.flow_dirs[cam_idx]:
            return None
        from ..data.flow import load_flow, target_name
        path = self.flow_dirs[cam_idx][
            self.rng.randint(len(self.flow_dirs[cam_idx]))]
        tgt = target_name(path)
        if tgt not in self._name2idx:
            return None
        j = self._name2idx[tgt]
        cam1 = self.cameras[cam_idx]
        try:
            flow, mask = load_flow(path, cam1.H, cam1.W)
        except (OSError, ValueError):
            return None
        pw = float(np.clip(np.cos(abs(self._times[cam_idx] - self._times[j])
                                  * np.pi / 2.0), 0.2, 1.0))
        as_t = lambda a: torch.as_tensor(a, device=self.device)
        return self.cameras[j], as_t(flow), as_t(mask), pw

    def _motion_lambda(self, it: int) -> float:
        """Landmark-scheduled motion-mask weight (arguments/__init__.py:
        149-151); 0 while the loss is off."""
        cfg = self.cfg
        if (not cfg.gt_alpha_mask_as_dynamic_mask or cfg.no_motion_mask_loss
                or self.alphas is None):
            return 0.0
        return float(R.landmark_interpolate(
            cfg.lambda_motion_mask_landmarks, cfg.lambda_motion_mask_steps,
            step=max(0, it)))

    # --- stage 1 ---
    def node_stage_iteration(self):
        cfg = self.cfg
        it = self.iteration_node
        cam, gt, alpha = self._pick_camera()
        motion = (self._motion_lambda(0) > 0 and alpha is not None
                  and it > cfg.node_warm_up
                  and self.state.ngauss.with_motion_mask)
        sched = dict(
            warm=1.0 if it < cfg.node_warm_up else 0.0,
            reg_on=1.0 if it > cfg.node_warm_up else 0.0,
            deform_lr=self.deform_sched(it), xyz_lr=self.xyz_sched(it),
            time_interval=self.time_interval, step=it)
        # at the sampling/downsample boundary no optimizer step is taken
        # (train_gui.py:584-591)
        if it != cfg.iterations_node_sampling:
            self.state, metrics = node_stage_step(
                self.state, cam, gt, cfg, sched,
                gt_alpha=alpha if motion else None, motion_loss=motion)
        else:
            metrics = {}
        if it < cfg.iterations_node_sampling:
            if (it % cfg.densification_interval == 0
                    or it == cfg.node_warm_up - 1):
                prune_big = it > cfg.opacity_reset_interval
                self.state, _ = densify_step(
                    self.state, cfg, "node", self.extent, 0.005, prune_big,
                    cfg.densify_grad_threshold)
            if (it % cfg.opacity_reset_interval == 0
                    or (cfg.white_background and it == cfg.densify_from_iter)):
                self.state = reset_opacity_step(self.state, "node")
        elif it == cfg.iterations_node_sampling:
            self.state = node_downsample_step(self.state, cfg)
        if it == cfg.iterations_node_rendering - 1:
            self.state = adopt_node_positions(self.state)
        self.iteration_node += 1
        return metrics

    def _sharded_iteration(self, sched):
        """One main-stage step on the rank grid: n_data cameras (the same
        picks on every rank), the full loss set, the densify statistics."""
        n_data = self._mesh.n_data
        picks = [self._pick_camera() for _ in range(n_data)]
        cams = [p[0] for p in picks]
        gts = torch.stack([p[1] for p in picks])
        if self._sharded_motion:
            sched = dict(sched, lambda_motion=self._motion_lambda(
                self.iteration))
            alphas = torch.stack([
                p[2] if p[2] is not None else
                torch.zeros(p[1].shape[:2] + (1,), device=self.device)
                for p in picks])
            return self._sharded_step(self.state, cams, gts, sched, alphas)
        return self._sharded_step(self.state, cams, gts, sched)

    # --- stage 2 ---
    def main_iteration(self):
        cfg = self.cfg
        it = self.iteration
        if it % cfg.oneup_sh_degree_step == 0:
            self.state = oneup_sh(self.state, cfg)
        lam_arap = R.landmark_interpolate(
            *cfg.node_cfg.lambda_arap_schedule, step=max(0, it))
        late = it > cfg.normal_dist_from_iter
        sched = dict(
            warm=1.0 if it < cfg.warm_up else 0.0,
            lambda_normal=cfg.lambda_normal if late else 0.0,
            lambda_dist=cfg.lambda_dist if late else 0.0,
            lambda_arap=float(lam_arap),
            deform_lr=self.deform_sched(it), xyz_lr=self.xyz_sched(it),
            step=it)
        if self._sharded_step is not None:
            self.state, metrics = self._sharded_iteration(sched)
            self._post_main_maintenance(it)
            self.iteration += 1
            return metrics
        cam, gt, alpha = self._pick_camera()
        lam_motion = self._motion_lambda(it)
        motion = lam_motion > 0 and alpha is not None
        if motion:
            sched["lambda_motion"] = lam_motion
        flow_sample = None
        if self.flow_dirs is not None and it >= cfg.warm_up:
            lam_opt = float(R.landmark_interpolate(
                cfg.lambda_optical_landmarks, cfg.lambda_optical_steps,
                step=max(0, it)))
            if lam_opt > 0:
                flow_sample = self._pick_flow_sample(self._last_cam_idx)
                if flow_sample is not None:
                    sched["lambda_optical"] = lam_opt
        self.state, metrics = main_stage_step(
            self.state, cam, gt, cfg, sched,
            gt_alpha=alpha if motion else None, motion_loss=motion,
            flow_sample=flow_sample, flow_loss=flow_sample is not None)
        if flow_sample is not None:
            metrics["lambda_optical"] = sched["lambda_optical"]
        self._post_main_maintenance(it)
        self.iteration += 1
        return metrics

    def _main_maintenance(self, it: int) -> list:
        """The maintenance due after main-stage step ``it``
        (train_gui.py:410-423), in order: "node_densify", "densify",
        "reset"."""
        cfg = self.cfg
        if it >= cfg.densify_until_iter:
            return []
        due = []
        if cfg.deform_type == "node" and (
                it == cfg.node_force_densify_prune_step
                or (cfg.node_enable_densify_prune
                    and it > cfg.node_densify_from_iter
                    and it % cfg.node_densification_interval == 0
                    and it < cfg.node_densify_until_iter
                    and it > cfg.warm_up)):
            due.append("node_densify")
        if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
            due.append("densify")
        if (it % cfg.opacity_reset_interval == 0
                or (cfg.white_background and it == cfg.densify_from_iter)):
            due.append("reset")
        return due

    def _post_main_maintenance(self, it: int):
        """Densify / opacity-reset schedule after a main-stage step.  On
        sharded state every rank gathers the whole state, runs the same
        maintenance with the same draws and keeps its shard again, so the
        result is the unsharded Trainer's."""
        cfg = self.cfg
        due = self._main_maintenance(it)
        if not due:
            return
        with trace.span("d2dgs.maintain"):
            if self._mesh is not None:
                from ..parallel import shard_gauss_state
                self.state = self.full_state()
            for what in due:
                if what == "node_densify":
                    self.state, _ = node_densify_step(
                        self.state, cfg, cfg.densify_grad_threshold)
                elif what == "densify":
                    self.state, _ = densify_step(
                        self.state, cfg, "main", self.extent, 0.01,
                        it > cfg.opacity_reset_interval,
                        cfg.densify_grad_threshold)
                else:
                    self.state = reset_opacity_step(self.state, "main")
            if self._mesh is not None:
                self.state = shard_gauss_state(self._mesh, self.state)

    def step(self):
        with trace.span("d2dgs.step"):
            self._poll_viewer()
            if self.iteration_node < self.cfg.iterations_node_rendering:
                return self.node_stage_iteration()
            return self.main_iteration()

    def total_iterations(self) -> int:
        """Steps the full schedule takes (node stage only for "node")."""
        node = (self.cfg.iterations_node_rendering
                if self.cfg.deform_type == "node" else 0)
        return self.cfg.iterations + node

    def train(self, num_iters: int | None = None, log_every: int = 100):
        total = (num_iters if num_iters is not None
                 else self.total_iterations())
        for _ in range(total):
            m = self.step()
            tick = self.iteration_node + self.iteration
            if m and tick % log_every == 0:
                self.log_fn(dict({k: float(v) for k, v in m.items()},
                                 iter=self.iteration,
                                 iter_node=self.iteration_node))
        return self.state
