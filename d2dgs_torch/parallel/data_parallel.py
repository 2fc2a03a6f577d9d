"""Data-parallel training: a batch of (camera, time) samples split over
the ranks of a group (counterpart of d2dgs_tpu/parallel/data_parallel.py).

The reference trains batch-1 on one GPU (train_gui.py:238-258 picks one
camera per step).  One batched step of B cameras is B reference
iterations' gradients averaged into one Adam update; the densify
statistics count each view as B separate iterations would
(``add_stats_batched`` scales the 1/B of the loss mean back).
``batched_main_step`` is that step in one process; ``make_dp_main_step``
splits the batch over a process group: every rank holds the whole model,
takes its B / n cameras, and one all-reduce of one flat gradient buffer
(plus one of the densify statistics) makes every rank's update the same.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import densify as D
from ..models import regularizers as R
from ..models.deform import add_field_regulariser
from ..ops.ssim import psnr
from ..train.config import TrainConfig
from ..train.optim import adam_update
from ..train.trainer import (TrainState, gauss_lr_tree, gauss_trainable,
                             mlp_trainable, node_trainable, photometric_loss)


def stack_cameras(cams) -> list:
    """The cameras of a batch, in order (the JAX package stacks them into
    one pytree; here a batch is a list)."""
    return list(cams)


def add_stats_batched(stats: D.DensifyStats, screen_grad: torch.Tensor,
                      visible: torch.Tensor, radii: torch.Tensor,
                      batch: int) -> D.DensifyStats:
    """Fold a batch of per-view screen-gradient probes into the densify
    statistics as ``batch`` sequential reference iterations would
    (gaussian_model.py:484-486); the loss takes a 1/B mean over views, so
    each view's probe gradient is scaled back by B.
    screen_grad [B,C,2]; visible [B,C] bool; radii [B,C]."""
    g = torch.linalg.vector_norm(screen_grad, dim=-1) * float(batch)
    return D.DensifyStats(
        grad_accum=stats.grad_accum + torch.sum(torch.where(visible, g, 0.0),
                                                dim=0),
        denom=stats.denom + torch.sum(visible.to(torch.float32), dim=0),
        max_radii2d=torch.maximum(stats.max_radii2d, torch.amax(
            torch.where(visible, radii, 0.0), dim=0)))


def _batch_grads(state: TrainState, cams, gts, cfg: TrainConfig,
                 sched: dict, batch: int, arap_weight: float,
                 arap_draws: R.ArapDraws):
    """The gradients of sum_b L_b / batch + arap_weight * (ARAP, or the
    hexplane planes' regulariser) over the views ``cams`` (a part of the
    batch or all of it).  Returns (the three groups, their gradients in
    order, the probe gradient [b, C, 2], the render outputs, the L1s)."""
    dev = state.gauss.xyz.device
    bg = (1.0 if cfg.white_background else 0.0) * torch.ones(3, device=dev)
    groups = [gauss_trainable(state.gauss), mlp_trainable(state.nodes),
              node_trainable(state.nodes)]
    probe = torch.zeros((len(cams), state.gauss.capacity, 2), device=dev,
                        requires_grad=True)
    loss, outs, ll1s = 0.0, [], []
    for b, (cam, gt) in enumerate(zip(cams, gts)):
        lb, (out, ll1) = photometric_loss(state.gauss, state.nodes, cam, gt,
                                          probe[b], cfg, sched, bg)
        loss = loss + lb / batch
        outs.append(out)
        ll1s.append(ll1.detach())
    # the node-level term is camera-independent: added once, not per view
    # (node models only, as in main_stage_step)
    if cfg.deform_type == "node":
        loss = loss + arap_weight * (1.0 - sched["warm"]) * \
            sched["lambda_arap"] * R.arap_loss(state.nodes, cfg.node_cfg,
                                               arap_draws)
    loss = add_field_regulariser(loss, state.nodes, cfg.deform_cfg,
                                 arap_weight)
    inputs = [p for g in groups for p in g.values()]
    grads = torch.autograd.grad(loss, inputs + [probe], allow_unused=True)
    flat = [torch.zeros_like(p) if gr is None else gr
            for gr, p in zip(grads[:-1], inputs)]
    g_probe = grads[-1] if grads[-1] is not None else torch.zeros_like(probe)
    return groups, flat, g_probe, outs, ll1s


def _apply(state: TrainState, groups, grads, cfg, sched, stats):
    """The three Adam groups on ``grads`` (in the groups' order)."""
    opts, lrs, out, i = (state.gauss_opt, state.mlp_opt, state.node_opt), (
        gauss_lr_tree(cfg, sched["xyz_lr"]), sched["deform_lr"],
        cfg.deform_lr_init), [], 0
    for grp, opt, lr in zip(groups, opts, lrs):
        out.append(adam_update(dict(zip(grp, grads[i:i + len(grp)])), opt,
                               grp, lr))
        i += len(grp)
    return state._replace(gauss_opt=out[0], mlp_opt=out[1],
                          node_opt=out[2], gauss_stats=stats)


def batched_main_step(state: TrainState, cams, gts: torch.Tensor,
                      cfg: TrainConfig, sched: dict,
                      arap_draws: R.ArapDraws | None = None):
    """The main-stage step over a camera batch (cams: a list of B cameras,
    gts [B,H,W,3]), in one process.  The ARAP draws are ``arap_draws`` or
    drawn from ``state.generator``.  Returns (state, metrics)."""
    batch = len(cams)
    if cfg.deform_type == "node" and arap_draws is None:
        arap_draws = R.arap_draws(state.generator, state.nodes.nodes.shape[0])
    groups, grads, g_probe, outs, ll1s = _batch_grads(
        state, cams, gts, cfg, sched, batch, 1.0, arap_draws)
    stats = add_stats_batched(
        state.gauss_stats, g_probe, torch.stack([o.visibility for o in outs]),
        torch.stack([o.radii.to(torch.float32) for o in outs]), batch)
    state = _apply(state, groups, grads, cfg, sched, stats)
    metrics = dict(loss=torch.stack(ll1s).mean(),
                   psnr=torch.stack([psnr(o.image.detach(), gt)
                                     for o, gt in zip(outs, gts)]).mean(),
                   num_pairs=torch.stack([o.num_pairs for o in outs]).max(),
                   overflow=torch.stack([o.overflow for o in outs]).max())
    return state, metrics


def make_dp_main_step(cfg: TrainConfig, group=None):
    """``batched_main_step`` with the batch split over the ranks of
    ``group`` (None: the default group).  Returns fn(state, cams, gts,
    sched, arap_draws=None) -> (state, metrics), called on every rank with
    the whole batch (B divisible by the group's size); each rank renders
    its B / n cameras and the state stays the same on every rank."""
    def step(state, cams, gts, sched, arap_draws=None):
        n = dist.get_world_size(group)
        r = dist.get_rank(group)
        batch = len(cams)
        if batch % n:
            raise ValueError(f"a batch of {batch} does not split over {n} "
                             f"ranks")
        per = batch // n
        mine = slice(r * per, (r + 1) * per)
        if cfg.deform_type == "node" and arap_draws is None:
            arap_draws = R.arap_draws(state.generator,
                                      state.nodes.nodes.shape[0])
        groups, grads, g_probe, outs, ll1s = _batch_grads(
            state, cams[mine], gts[mine], cfg, sched, batch, 1.0 / n,
            arap_draws)
        # one bucket: every gradient, then the densify sums and the
        # metrics' sums
        vis = torch.stack([o.visibility for o in outs])
        gn = torch.linalg.vector_norm(g_probe, dim=-1) * float(batch)
        sums = torch.stack([torch.where(vis, gn, 0.0).sum(0),
                            vis.to(torch.float32).sum(0)])
        ll1 = torch.stack(ll1s).sum()[None] / batch
        ps = torch.stack([psnr(o.image.detach(), gt) for o, gt in zip(
            outs, gts[mine])]).sum()[None] / batch
        buf = torch.cat([g.reshape(-1) for g in grads] + [
            sums.reshape(-1), ll1, ps])
        dist.all_reduce(buf, group=group)
        radii = torch.amax(torch.where(vis, torch.stack(
            [o.radii.to(torch.float32) for o in outs]), 0.0), dim=0)
        peaks = torch.stack([torch.stack([o.num_pairs for o in outs]).max(),
                             torch.stack([o.overflow for o in outs]).max()]
                            ).to(torch.int64)
        dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=group)
        i, summed = 0, []
        for g in grads:
            summed.append(buf[i:i + g.numel()].view_as(g))
            i += g.numel()
        sums = buf[i:i + sums.numel()].view_as(sums)
        st = state.gauss_stats
        stats = D.DensifyStats(grad_accum=st.grad_accum + sums[0],
                               denom=st.denom + sums[1],
                               max_radii2d=torch.maximum(st.max_radii2d,
                                                         radii))
        state = _apply(state, groups, summed, cfg, sched, stats)
        metrics = dict(loss=buf[-2], psnr=buf[-1], num_pairs=peaks[0],
                       overflow=peaks[1])
        return state, metrics
    return step
