"""The main-stage training step over a 2-D (data x gauss) rank grid with
the sharded renderer and its tile-binning exchange (counterpart of
d2dgs_tpu/parallel/gauss_train.py).

Each data row trains one camera per step with the complete main-stage
loss set (train_gui.py:286-370): L1 + D-SSIM, normal consistency,
distortion, node ARAP, the optional motion-mask term, and the
screen-probe densify statistics.  The rows' gradients average into one
Adam update, as ``data_parallel.batched_main_step`` does.

Layout: each rank holds its shard of the per-Gaussian leaves (the
Gaussians, their Adam moments and densify statistics; ``shard_gauss_state``)
and a copy of everything else (the deform field, the nodes, their
moments, the generator), which every rank updates with the same numbers
and so keeps bitwise equal.

The gradient recipe.  Every rank of a row computes the row's image loss
L_i from the same gathered image, and the slab gather's backward keeps
each rank's own slab's cotangent (gauss_shard.py), so differentiating
L_i on a rank gives its Gaussians their whole dL_i and the replicated
parameters its Gaussians' share of it.  The node-graph term A, which
every rank computes alike, enters each rank's loss as A / n_gauss.  Each
rank differentiates (L_i + A / n_gauss) / n_data: its Gaussians' leaves
are summed over the data column, the replicated leaves over every rank,
one all-reduce each; that is the mean over the rows of dL_i, plus dA.
The densify probe's gradient, dL_i / n_data, is scaled back by n_data
per view and summed over the column, as ``add_stats_batched`` does.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.distributed as dist

from ..models import densify as D
from ..models import regularizers as R
from ..models.deform import add_field_regulariser, deform_gaussians
from ..models.gaussians import GaussianParams, apply_deform
from ..ops.projection import tile_grid
from ..ops.ssim import l1, psnr, ssim
from ..render.renderer import postprocess_maps
from ..train.config import TrainConfig
from ..train.optim import AdamState, adam_update
from ..train.trainer import (GAUSS_FIELDS, TrainState, gauss_lr_tree,
                             gauss_trainable, mlp_trainable, node_trainable)
from ..utils.sh import sh_to_rgb
from .gauss_shard import assemble_interleaved, shard_render_core
from .multihost import RankGrid, global_mesh

__all__ = ["gather_gauss_state", "gauss_sharded_step",
           "make_gauss_mesh", "make_gauss_sharded_step", "make_mesh2d",
           "make_sharded_train_step", "shard_gauss_state",
           "sharded_train_step"]


def make_gauss_mesh(n_devices: int = 1) -> RankGrid:
    """A 1 x n grid: every rank shards the Gaussians of one camera."""
    return global_mesh((1, n_devices))


def make_mesh2d(n_data: int, n_gauss: int) -> RankGrid:
    """The (data x gauss) grid: rows train distinct cameras, columns shard
    the Gaussians and the tiles."""
    return global_mesh((n_data, n_gauss))


def _map_gauss(state: TrainState, f) -> TrainState:
    """``state`` with ``f`` applied to every per-Gaussian leaf of the main
    Gaussians, their Adam moments and densify statistics."""
    g = state.gauss
    gauss = GaussianParams(
        **{k: f(getattr(g, k).detach()) for k in GAUSS_FIELDS},
        alive=f(g.alive), active_sh_degree=g.active_sh_degree,
        with_motion_mask=g.with_motion_mask,
        isotropic_shared_scale=g.isotropic_shared_scale)
    opt = state.gauss_opt
    gauss_opt = AdamState(mu={k: f(v) for k, v in opt.mu.items()},
                          nu={k: f(v) for k, v in opt.nu.items()},
                          count=opt.count)
    stats = D.DensifyStats(*(f(v) for v in state.gauss_stats))
    return state._replace(gauss=gauss, gauss_opt=gauss_opt,
                          gauss_stats=stats)


def shard_gauss_state(mesh: RankGrid, state: TrainState) -> TrainState:
    """This rank's state: the per-Gaussian leaves cut to its block of the
    capacity (gauss_idx of n_gauss equal blocks), the rest shared."""
    cap, n = state.gauss.capacity, mesh.n_gauss
    if cap % n:
        raise ValueError(f"capacity {cap} does not split over {n} ranks")
    m = cap // n
    j = mesh.gauss_idx
    return _map_gauss(state, lambda x: x[j * m:(j + 1) * m].clone())


def gather_gauss_state(mesh: RankGrid, state: TrainState) -> TrainState:
    """The whole state from every rank's shard (a collective over the
    gauss group: every rank of the row calls it)."""
    if mesh.gauss_group is None:
        return state

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(mesh.n_gauss)]
        dist.all_gather(parts, x.contiguous(), group=mesh.gauss_group)
        return torch.cat(parts)
    return _map_gauss(state, gather)


def _all_reduce(t: torch.Tensor, group, on: bool,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if on:
        dist.all_reduce(t, op=op, group=group)
    return t


def _flat(grads, params) -> torch.Tensor:
    """The gradients of ``params`` (None as zeros) as one flat buffer."""
    return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params)])


def _unflat(buf: torch.Tensor, params) -> list:
    out, i = [], 0
    for p in params:
        out.append(buf[i:i + p.numel()].view_as(p))
        i += p.numel()
    return out


def sharded_train_step(state: TrainState, cams, gts: torch.Tensor,
                       sched: dict, cfg: TrainConfig, mesh: RankGrid,
                       exchange_cap: int, gt_alphas=None,
                       motion_loss: bool = False,
                       arap_draws: R.ArapDraws | None = None):
    """One full-loss main-stage step of this rank (state: its shard,
    ``shard_gauss_state``).  cams: the n_data cameras of the step (a
    list, the same on every rank; row i trains cams[i]); gts [n_data, H,
    W, 3]; gt_alphas [n_data, H, W, 1] with ``motion_loss``.  sched: the
    ``main_stage_step`` scalars (warm, lambda_normal, lambda_dist,
    lambda_arap, deform_lr, xyz_lr, step [, lambda_motion]).  The ARAP
    term's draws are ``arap_draws`` or drawn from ``state.generator``,
    identically on every rank.  Returns (state, metrics) with the
    metrics of the whole grid."""
    n_data, n_gauss = mesh.n_data, mesh.n_gauss
    i = mesh.data_idx
    cam, gt = cams[i], gts[i]
    g, nodes = state.gauss, state.nodes
    dev = g.xyz.device
    H, W = gt.shape[0], gt.shape[1]
    gx, gy = tile_grid(H, W)
    bg = (1.0 if cfg.white_background else 0.0) * torch.ones(3, device=dev)
    render_kw = dict(grid_x=gx, grid_y=gy, n_dev=n_gauss, cfg=cfg.raster,
                     exchange_cap=exchange_cap, dev_id=mesh.gauss_idx,
                     group=mesh.gauss_group)
    groups = [gauss_trainable(g), mlp_trainable(nodes), node_trainable(nodes)]
    probe = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
    if cfg.deform_type == "node" and arap_draws is None:
        arap_draws = R.arap_draws(state.generator, nodes.nodes.shape[0])

    d = deform_gaussians(nodes, cfg.deform_cfg, g, cam.time,
                         step=sched.get("step", 10**9))
    w = sched["warm"]

    def gate(x):
        return None if x is None else x.detach() * w + x * (1.0 - w)

    means3d, scales, quats, opacity, sh = apply_deform(
        g, gate(d["d_xyz"]), gate(d["d_rotation"]), gate(d["d_scaling"]),
        gate(d["d_opacity"]), gate(d["d_color"]))
    dirs = means3d - cam.cam_center[None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True)
                             + 1e-20)
    colors = sh_to_rgb(g.active_sh_degree, sh, dirs)
    color_all, allmap_all, overflow, radii = shard_render_core(
        cam, means3d, scales, quats, opacity, colors, g.alive,
        screen_probe=probe, **render_kw)
    image, allmap = assemble_interleaved(color_all, allmap_all, bg, gx, gy,
                                         H, W)
    _alpha, rend_normal, rend_dist, _sd, surf_normal = postprocess_maps(
        cam, image, allmap, bg, False, cfg.raster)
    ll1 = l1(image, gt)
    loss = ((1.0 - cfg.lambda_dssim) * ll1
            + cfg.lambda_dssim * (1.0 - ssim(image, gt)))
    normal_err = 1.0 - torch.sum(rend_normal * surf_normal, dim=-1)
    loss = loss + sched["lambda_normal"] * torch.mean(normal_err)
    loss = loss + sched["lambda_dist"] * torch.mean(rend_dist)
    if cfg.deform_type == "node":
        # the node-graph term, the same on every rank: 1 / n_gauss each
        loss = loss + (1.0 - w) * sched["lambda_arap"] * R.arap_loss(
            nodes, cfg.node_cfg, arap_draws) / n_gauss
    loss = add_field_regulariser(loss, nodes, cfg.deform_cfg, 1.0 / n_gauss)
    if motion_loss:
        # the motion-mask term on detached geometry (train_gui.py:363-370):
        # colours [mask, 0, 1 - mask]
        mm = g.motion_mask
        override = torch.cat([mm, torch.zeros_like(mm), 1.0 - mm], dim=-1)
        m_col, m_map, _, _ = shard_render_core(
            cam, means3d.detach(), scales.detach(), quats.detach(),
            opacity.detach(), override, g.alive, **render_kw)
        m_img, _ = assemble_interleaved(m_col, m_map, bg, gx, gy, H, W)
        loss = loss + sched["lambda_motion"] * l1(m_img[..., 0],
                                                  gt_alphas[i][..., 0])

    params = [list(grp.values()) for grp in groups]
    flat_in = [p for ps in params for p in ps]
    # with a process group the loss always reaches the exchange (the slab
    # gather's anchor); in one process a view where nothing is drawn
    # leaves it a constant of the background, and every gradient zero
    grads = (torch.autograd.grad(loss / n_data,
                                 flat_in + [probe], allow_unused=True)
             if loss.requires_grad else [None] * (len(flat_in) + 1))
    n_g = len(params[0])
    # one bucket per reduction: the shard's leaves over the data column,
    # the replicated leaves over every rank
    g_gauss = _all_reduce(_flat(grads[:n_g], params[0]), mesh.data_group,
                          mesh.world)
    rep = params[1] + params[2]
    g_rep = _all_reduce(_flat(grads[n_g:len(flat_in)], rep), None,
                        mesh.world)
    g_gauss, g_rep = _unflat(g_gauss, params[0]), _unflat(g_rep, rep)
    n_mlp = len(params[1])
    gauss_opt = adam_update(dict(zip(groups[0], g_gauss)), state.gauss_opt,
                            groups[0], gauss_lr_tree(cfg, sched["xyz_lr"]))
    mlp_opt = adam_update(dict(zip(groups[1], g_rep[:n_mlp])), state.mlp_opt,
                          groups[1], sched["deform_lr"])
    node_opt = adam_update(dict(zip(groups[2], g_rep[n_mlp:])),
                           state.node_opt, groups[2], cfg.deform_lr_init)

    # densify statistics: each view's probe gradient scaled back by
    # n_data, summed over the rows (add_stats_batched)
    g_probe = grads[-1] if grads[-1] is not None else torch.zeros_like(probe)
    vis = radii > 0
    gn = torch.linalg.vector_norm(g_probe, dim=-1) * float(n_data)
    sums = _all_reduce(torch.stack([torch.where(vis, gn, 0.0),
                                    vis.to(torch.float32)]),
                       mesh.data_group, mesh.world)
    rmax = _all_reduce(torch.where(vis, radii.to(torch.float32), 0.0),
                       mesh.data_group, mesh.world, op=dist.ReduceOp.MAX)
    st = state.gauss_stats
    stats = D.DensifyStats(grad_accum=st.grad_accum + sums[0],
                           denom=st.denom + sums[1],
                           max_radii2d=torch.maximum(st.max_radii2d, rmax))
    # the grid's metrics: row means of L1 and PSNR, the exchange overflow
    # summed over the rows, the Gaussians alive over the columns
    m = torch.stack([ll1.detach().double() / (n_gauss * n_data),
                     psnr(image.detach(), gt).double() / (n_gauss * n_data),
                     overflow.double() / n_gauss,
                     g.num_alive.double() / n_data])
    m = _all_reduce(m, None, mesh.world)
    metrics = dict(loss=m[0].float(), psnr=m[1].float(),
                   overflow=m[2].round().long(), alive=m[3].round().long())
    return state._replace(gauss_opt=gauss_opt, mlp_opt=mlp_opt,
                          node_opt=node_opt, gauss_stats=stats), metrics


def make_sharded_train_step(mesh: RankGrid, cfg: TrainConfig,
                            exchange_cap: int, motion_loss: bool = False):
    """fn(state, cams, gts, sched[, gt_alphas]) -> (state, metrics): the
    full-loss sharded step with its configuration bound (PyTorch runs
    eagerly; the JAX package jits here)."""
    fn = partial(sharded_train_step, cfg=cfg, mesh=mesh,
                 exchange_cap=exchange_cap, motion_loss=motion_loss)
    if motion_loss:
        return lambda state, cams, gts, sched, alphas, **kw: fn(
            state, cams, gts, sched, gt_alphas=alphas, **kw)
    return lambda state, cams, gts, sched, **kw: fn(state, cams, gts, sched,
                                                    **kw)


def _full_sched(sched: dict) -> dict:
    full = dict(sched)
    for k in ("lambda_normal", "lambda_dist", "lambda_arap"):
        full.setdefault(k, 0.0)
    return full


def gauss_sharded_step(state: TrainState, cam, gt: torch.Tensor,
                       sched: dict, cfg: TrainConfig, mesh: RankGrid,
                       exchange_cap: int = 4096, **kw):
    """One camera over a 1 x n grid; the geometric terms default to off."""
    return sharded_train_step(state, [cam], gt[None], _full_sched(sched),
                              cfg, mesh, exchange_cap, **kw)


def make_gauss_sharded_step(mesh: RankGrid, cfg: TrainConfig,
                            exchange_cap: int = 4096):
    return lambda state, cam, gt, sched, **kw: gauss_sharded_step(
        state, cam, gt, sched, cfg, mesh, exchange_cap, **kw)
