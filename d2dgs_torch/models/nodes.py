"""Sparse-control-node deformation (counterpart of d2dgs_tpu/models/nodes.py,
the reference's ControlNodeWarp, utils/time_utils.py:770-1387).

M control nodes carry (xyz + hyper coords), a log radius and a weight
logit.  A Gaussian's deformation is the KNN(K=3)-weighted blend of the
per-node MLP deltas, gated by its motion mask; the KNN runs in
(xyz + hyper) space with Gaussian-kernel weights exp(-d^2 / 2r^2) * w_node.
Nodes are capacity-padded with an ``alive`` mask (dead nodes are at
+inf distance); node densification (``densify_nodes``) adds and prunes
nodes slot for slot as the JAX package does.  Skinning is a linear blend
of the per-node transforms (plain or rigid local frames) or, with
``skinning="dqb"`` and local frames, a dual-quaternion blend.  The
editing warp (``warp_with_bias``) moves the nodes by a bias, fits their
rotations (``p2dR``) and re-binds the Gaussians to the moved nodes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import trace
from ..ops.cuda.node_gather import gather_rows
from ..ops.knn import knn
from ..utils.dual_quaternion import dq_blend, quat_apply
from ..utils.general import farthest_point_sample, resolve_device
from ..utils.quaternion import (quat_multiply, quat_normalize,
                                quat_to_rotmat, rotmat_to_quat)
from .deform_mlp import MLPConfig, init_mlp, mlp_forward
from .densify import free_slot_lookup

ROT_BIAS = (1.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    node_num: int = 512          # capacity M
    K: int = 3
    hyper_dim: int = 8
    d_rot_as_res: bool = True
    with_node_weight: bool = True
    # the main stage's ARAP weight follows lambda_arap_schedule when on
    with_arap_loss: bool = False
    is_scene_static: bool = False
    # "lbs": linear blend of per-node transforms; "dqb": dual-quaternion
    # blend of the rigid local frames (with mlp.local_frame only)
    skinning: str = "lbs"
    # float32 KNN membership selection; False selects on a bfloat16 copy
    # of the distances exactly as the JAX package does (only near-tie
    # memberships differ from the float32 selection)
    exact_knn: bool = False
    mlp: MLPConfig = MLPConfig()

    @property
    def lambda_arap_schedule(self):
        """(landmarks, steps) of the ARAP weight (time_utils.py:790-795)."""
        if self.with_arap_loss and not self.is_scene_static:
            return ([1e-4, 1e-4, 1e-5, 1e-5, 0],
                    [0, 5000, 10000, 20000, 20001])
        return ([0], [0])


class NodeParams(nn.Module):
    """nodes [M, 3+hyper], node_radius [M] log radius, node_weight [M,1]
    logit, the deform MLP, and alive [M] bool buffer."""

    def __init__(self, nodes, node_radius, node_weight, mlp: nn.ModuleDict,
                 alive):
        super().__init__()
        self.nodes = nn.Parameter(nodes)
        self.node_radius = nn.Parameter(node_radius)
        self.node_weight = nn.Parameter(node_weight)
        self.mlp = mlp
        self.register_buffer("alive", alive)

    @property
    def num_alive(self):
        return torch.sum(self.alive.to(torch.int32))


def init_node_params(cfg: NodeConfig, generator: torch.Generator | None = None,
                     device="cuda") -> NodeParams:
    """Random nodes and MLP, drawn on the CPU from ``generator``."""
    dev = resolve_device(device)
    m = cfg.node_num
    nodes = torch.randn((m, 3 + cfg.hyper_dim), generator=generator)
    radius = torch.randn((m,), generator=generator)
    mlp = init_mlp(cfg.mlp, generator, dev)
    return NodeParams(nodes.to(dev), radius.to(dev),
                      torch.zeros((m, 1), device=dev), mlp,
                      torch.ones((m,), dtype=torch.bool, device=dev))


@torch.no_grad()
def init_nodes_from_pcl(params: NodeParams, cfg: NodeConfig,
                        pcl: torch.Tensor,
                        generator: torch.Generator | None = None,
                        start: int | None = None,
                        sample_pcl: torch.Tensor | None = None) -> NodeParams:
    """FPS-sample node positions from a point cloud, hyper coords 1e-2,
    radius log(0.1 * scene_range) (time_utils.py:886-927).  The FPS start
    is ``start`` or drawn from ``generator``.  Updates ``params`` in place
    and returns it."""
    m = cfg.node_num
    dev = params.nodes.device
    pcl = pcl.to(dev)
    scene_range = torch.max(pcl) - torch.min(pcl)
    n = pcl.shape[0]
    xyz = torch.zeros((m, 3), dtype=pcl.dtype, device=dev)
    alive = torch.zeros((m,), dtype=torch.bool, device=dev)
    if n <= m:
        xyz[:n] = pcl
        alive[:n] = True
    else:
        idx = farthest_point_sample(
            pcl if sample_pcl is None else sample_pcl.to(dev), m,
            generator=generator, start=start)
        xyz[:] = pcl[idx.long()]
        alive[:] = True
    params.nodes.copy_(torch.cat(
        [xyz, 1e-2 * torch.ones((m, cfg.hyper_dim), device=dev)], dim=-1))
    params.node_radius.copy_(torch.log(0.1 * scene_range + 1e-7)
                             * torch.ones((m,), device=dev))
    params.node_weight.zero_()
    params.alive.copy_(alive)
    return params


def cal_nn_weight(params: NodeParams, cfg: NodeConfig, x: torch.Tensor,
                  feature: torch.Tensor | None, K: int | None = None,
                  nodes: torch.Tensor | None = None):
    """Gaussian->node binding weights (time_utils.py:934-967).

    x: [N,3] (detached inside); feature: [N,hyper] learnable hyper coords;
    nodes: node positions to bind to in place of ``params.nodes``.
    Returns (weight [N,K], dist2 [N,K], idx [N,K] int64).
    """
    K = cfg.K if K is None else K
    q = x.detach()
    base = params.nodes if nodes is None else nodes
    ref = base[:, :3].detach()
    if feature is not None and cfg.hyper_dim > 0:
        q = torch.cat([q, feature[..., :cfg.hyper_dim]], dim=-1)
        ref = torch.cat([ref, params.nodes[:, 3:]], dim=-1)
    # membership selection is non-differentiable: the full [N, M]
    # distance matrix is detached; K rounds of argmin pick the neighbours
    with torch.no_grad():
        q_sg, ref_sg = q.detach(), ref.detach()
        d2_full = (torch.sum(q_sg * q_sg, dim=-1, keepdim=True)
                   + torch.sum(ref_sg * ref_sg, dim=-1)[None, :]
                   - 2.0 * (q_sg @ ref_sg.T))
        d2_full = torch.clamp_min(d2_full, 0.0)
        d2_full = torch.where(params.alive[None, :], d2_full, float("inf"))
        d2_sel = d2_full if cfg.exact_knn else d2_full.to(torch.bfloat16)
        rows = torch.arange(d2_sel.shape[0], device=d2_sel.device)
        idxs = []
        for _ in range(K):
            i = torch.argmin(d2_sel, dim=1)
            idxs.append(i)
            trace.count("host.reads", 1)  # the value's copy from the host
            d2_sel[rows, i] = float("inf")
        idx = torch.stack(idxs, dim=-1)                       # [N,K]
    # differentiable distances recomputed only at the K selected nodes
    d_dim = ref.shape[-1]
    pack = torch.cat([ref, torch.exp(params.node_radius)[:, None],
                      params.node_weight], dim=-1)          # [M, D+2]
    pk = gather_rows(pack, idx)                             # [N,K,D+2]
    diff = q[:, None, :] - pk[..., :d_dim]
    nn_dist = torch.sum(diff * diff, dim=-1)                # [N,K]
    r = pk[..., d_dim]
    w = torch.exp(-nn_dist / (2.0 * r * r))
    if cfg.with_node_weight:
        w = w * torch.sigmoid(pk[..., d_dim + 1])
    w = w + 1e-7
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, nn_dist, idx


def expand_time(params: NodeParams, t) -> torch.Tensor:
    """scalar t -> [M,1]."""
    m = params.nodes.shape[0]
    return torch.as_tensor(t, dtype=torch.float32,
                           device=params.nodes.device).reshape(1, 1) \
        .expand(m, 1)


def node_deform(params: NodeParams, cfg: NodeConfig, t: torch.Tensor,
                detach_node: bool = True, step=10**9) -> dict:
    """Query the MLP at node positions. t: [M,1] or [M,T,1]."""
    xyz = params.nodes[:, :3]
    if detach_node:
        xyz = xyz.detach()
    if t.dim() == 3:
        m, tt, _ = t.shape
        xyz = xyz[:, None, :].expand(m, tt, 3)
    return mlp_forward(params.mlp, cfg.mlp, xyz, t, step=step)


def warp(params: NodeParams, cfg: NodeConfig, x: torch.Tensor, t,
         feature: torch.Tensor | None, motion_mask: torch.Tensor,
         step=10**9) -> dict:
    """Deform Gaussians at time t (ControlNodeWarp.forward,
    time_utils.py:1133-1226).

    x: [N,3] canonical xyz; t: scalar or [M,1]; motion_mask: [N,1].
    Returns dict(d_xyz [N,3], d_rotation [N,4], d_scaling [N,2],
    d_opacity, d_color).
    """
    t = expand_time(params, t) if torch.as_tensor(t).dim() == 0 else t
    x = x.detach()
    nn_weight, _, nn_idx = cal_nn_weight(params, cfg, x, feature)
    attrs = node_deform(params, cfg, t, step=step)
    node_trans, node_rot = attrs["d_xyz"], attrs["d_rotation"]
    node_scale = attrs["d_scaling"]
    m = params.nodes.shape[0]

    cols = [node_trans, node_rot, node_scale]
    if cfg.mlp.pred_opacity and attrs["d_opacity"] is not None:
        cols.append(attrs["d_opacity"])
    if cfg.mlp.pred_color and attrs["d_color"] is not None:
        cols.append(attrs["d_color"])
    trace.count("host.reads", 1)  # a copy from host memory
    bias = torch.tensor(ROT_BIAS, device=x.device)
    use_dqb = cfg.mlp.local_frame and cfg.skinning == "dqb"
    if cfg.mlp.local_frame and not use_dqb:
        # rigid local frames: A_k(x) = R_k (x - p_k) + p_k + tr_k factors
        # as (sum_k w R_k) x + sum_k w_k v_k, v_k = p_k + tr_k - R_k p_k
        Rl = quat_to_rotmat(attrs["local_rotation"] + bias)    # [M,3,3]
        p = params.nodes[:, :3].detach()
        v = p + node_trans - torch.einsum("mij,mj->mi", Rl, p)
        cols = [Rl.reshape(m, 9), v] + cols[1:]   # node_trans folded into v

    # K-row gather blend (the JAX package's dense [N, M] Wmat matmul is a
    # TPU layout choice): blended[n] = sum_k w[n,k] * cols[idx[n,k]]
    widths = [c.shape[-1] for c in cols]
    table = torch.cat(cols, dim=-1)                          # [M, sum(C)]
    blended = torch.sum(nn_weight[..., None] * gather_rows(table, nn_idx),
                        dim=1)
    parts = torch.split(blended, widths, dim=-1)

    if use_dqb:
        # dual-quaternion blend of the per-node rigid transforms
        # A_k(x) = R_k (x - p_k) + p_k + tr_k = (R_k, p_k + tr_k - R_k p_k)
        local_rot = quat_normalize(attrs["local_rotation"] + bias,
                                   eps=1e-12)
        nn_nodes = params.nodes[:, :3].detach()[nn_idx]        # [N,K,3]
        qk = local_rot[nn_idx]                                 # [N,K,4]
        tk = nn_nodes + node_trans[nn_idx] - quat_apply(qk, nn_nodes)
        qb, tb = dq_blend(qk, tk, nn_weight)
        translate = quat_apply(qb, x) + tb - x
        rot_b, scale_b, *rest = parts[1:]
    elif cfg.mlp.local_frame:
        Rb = parts[0].reshape(-1, 3, 3)
        translate = torch.einsum("nij,nj->ni", Rb, x) + parts[1] - x
        rot_b, scale_b, *rest = parts[2:]
    else:
        translate = parts[0]
        rot_b, scale_b, *rest = parts[1:]
    translate = translate * motion_mask

    if cfg.d_rot_as_res:
        rotation = rot_b * motion_mask
    else:
        # blend(node_rot + ROT_BIAS) == rot_b + ROT_BIAS (weights sum to 1)
        rotation = rot_b * motion_mask + bias
    scale = scale_b * motion_mask
    out = {"d_xyz": translate, "d_rotation": rotation, "d_scaling": scale,
           "d_opacity": None, "d_color": None}
    ri = 0
    if cfg.mlp.pred_opacity and attrs["d_opacity"] is not None:
        out["d_opacity"] = rest[ri] * motion_mask
        ri += 1
    if cfg.mlp.pred_color and attrs["d_color"] is not None:
        out["d_color"] = rest[ri] * motion_mask
    return out


@torch.no_grad()
def get_trajectory(params: NodeParams, cfg: NodeConfig,
                   t_samp_num: int = 8) -> torch.Tensor:
    """Node positions at linspace(0,1) timestamps, detached
    (time_utils.py:1026-1042).  Returns [M, T, 3]."""
    m = params.nodes.shape[0]
    t_samp = torch.linspace(0.0, 1.0, t_samp_num, device=params.nodes.device)
    t = t_samp[None, :, None].expand(m, t_samp_num, 1)
    d_xyz = node_deform(params, cfg, t)["d_xyz"]
    return params.nodes[:, None, :3] + d_xyz


@torch.no_grad()
def p2dR(params: NodeParams, cfg: NodeConfig, p: torch.Tensor,
         p0: torch.Tensor, K: int = 8, mode: str = "trajectory"):
    """SVD-fit per-node rotations from node positions
    (time_utils.py:1044-1078): neighbours from the trajectory KNN graph
    (``mode="trajectory"``) or the node positions, normalised edges at
    rest (p0) and deformed (p), weighted covariance, dR = V U^T as
    quaternions.  As in the reference, neighbours weigh
    softmax(d^2 / mean(d^2)) and no det(R) fix is applied, so a planar
    neighbourhood may give a reflection."""
    if mode == "trajectory":
        traj = get_trajectory(params, cfg, t_samp_num=4)
        feats = traj.reshape(traj.shape[0], -1)
    else:
        feats = params.nodes[:, :3]
    d2, idx = knn(feats, feats, K, exclude_self=True)
    w = torch.softmax(d2 / (torch.mean(d2) + 1e-12), dim=-1)   # [M,K]
    e0 = p0[idx] - p0[:, None, :]
    et = p[idx] - p[:, None, :]
    e0 = e0 / (torch.linalg.vector_norm(e0, dim=-1, keepdim=True) + 1e-5)
    et = et / (torch.linalg.vector_norm(et, dim=-1, keepdim=True) + 1e-5)
    S = torch.einsum("nka,nk,nkb->nab", e0, w, et)
    U, _, Vh = torch.linalg.svd(S)
    dR = torch.einsum("nji,nkj->nik", Vh, U)                   # V @ U^T
    return rotmat_to_quat(dR)


def warp_with_bias(params: NodeParams, cfg: NodeConfig, x: torch.Tensor,
                   t, feature, motion_mask, node_trans_bias: torch.Tensor,
                   K_rebind: int = 32) -> dict:
    """The editing warp: ``warp`` plus a per-node translation bias
    (ControlNodeWarp.forward's node_trans_bias paths,
    time_utils.py:1165-1214).  The bias moves the nodes, ``p2dR`` fits
    the induced per-node rotations, and the Gaussians, at their current
    positions, are re-bound to the ``K_rebind`` nearest moved nodes and
    carried rigidly about them.  The bias handling is detached, as in
    the reference's no_grad blocks."""
    base = warp(params, cfg, x, t, feature=feature, motion_mask=motion_mask)
    with torch.no_grad():
        t_e = (expand_time(params, t) if torch.as_tensor(t).dim() == 0
               else t)
        node_trans = node_deform(params, cfg, t_e)["d_xyz"]
        x = x.detach()
        cur_node = params.nodes[:, :3] + node_trans            # nodes at t
        nodes_t = cur_node + node_trans_bias                   # + edit bias
        node_rot_bias = p2dR(params, cfg, p=nodes_t, p0=cur_node, K=8)
        cur_gs = x + base["d_xyz"]
        nn_weight, _, nn_idx = cal_nn_weight(
            params, cfg, cur_gs, feature=None,
            K=min(K_rebind, params.nodes.shape[0]), nodes=cur_node)
        Rb = quat_to_rotmat(node_rot_bias)[nn_idx]             # [N,K,3,3]
        rel = cur_gs[:, None, :] - cur_node[nn_idx]
        gs_t = nodes_t[nn_idx] + torch.einsum("gkab,gkb->gka", Rb, rel)
        gs_avg = torch.sum(gs_t * nn_weight[..., None], dim=1)
        translate = (gs_avg - x) * motion_mask
        bias = torch.tensor(ROT_BIAS, device=x.device)
        d_rot_bias = torch.sum(node_rot_bias[nn_idx] * nn_weight[..., None],
                               dim=1)
        d_rot_bias = (d_rot_bias - bias) * motion_mask + bias
    out = dict(base)
    out["d_xyz"] = translate
    if cfg.d_rot_as_res:
        out["d_rotation_bias"] = d_rot_bias
    else:
        # fold the bias rotation into the absolute rotation field
        out["d_rotation"] = quat_multiply(d_rot_bias, base["d_rotation"])
    return out


# ----------------------------------------------------------------------
# Node densification (time_utils.py:1269-1386) under a fixed capacity
# ----------------------------------------------------------------------

@torch.no_grad()
def cal_node_importance(params: NodeParams, cfg: NodeConfig, x: torch.Tensor,
                        weights: torch.Tensor, feature: torch.Tensor | None):
    """Importance voting: each Gaussian adds its weighted influence to its
    K nearest nodes.  Returns (importance [M], avg_x [M, 3+hyper],
    edge_count [M])."""
    m = params.nodes.shape[0]
    xh = x
    if cfg.hyper_dim > 0 and feature is not None:
        xh = torch.cat([x, feature[..., :cfg.hyper_dim]], dim=-1)
    nn_weight, _, nn_idx = cal_nn_weight(params, cfg, x, feature)
    flat_idx = nn_idx.reshape(-1)
    ww = (nn_weight * weights[:, None]).reshape(-1)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=x.device)
    importance = zeros(m).index_add_(0, flat_idx, ww)
    edge_count = zeros(m).index_add_(0, flat_idx, nn_weight.reshape(-1))
    dim = xh.shape[-1]
    contrib = ww[:, None] * xh[:, None, :].expand(
        *nn_weight.shape, dim).reshape(-1, dim)
    avg_x = zeros(m, dim).index_add_(0, flat_idx, contrib)
    avg_x = avg_x / torch.clamp_min(importance[:, None], 1e-12)
    importance = importance / (edge_count + 1e-7)
    return importance, avg_x, edge_count


@torch.no_grad()
def densify_nodes(params: NodeParams, cfg: NodeConfig, mu: dict, nu: dict,
                  x: torch.Tensor, x_grad: torch.Tensor,
                  feature: torch.Tensor | None, max_grad: float,
                  alive_gaussians: torch.Tensor) -> dict:
    """Add a node at the importance-weighted mean of the Gaussians bound to
    each node whose importance exceeds ``max_grad``, and prune nodes no
    Gaussian binds to (time_utils.py:1286-1386).  Updates ``params`` and
    the Adam moment dicts ``mu``/``nu`` (keys nodes, node_radius,
    node_weight) in place; returns the info dict of 0-d counts (added,
    pruned)."""
    g = torch.nan_to_num(torch.linalg.vector_norm(x_grad, dim=-1))
    g = torch.where(alive_gaussians, g, 0.0)
    importance, avg_x, edge_count = cal_node_importance(
        params, cfg, x, g, feature)
    sel = params.alive & (importance > max_grad) & torch.all(
        torch.isfinite(avg_x), dim=-1)
    prune = params.alive & (edge_count == 0.0)
    alive = params.alive & ~prune

    m = params.nodes.shape[0]
    inv, num_free = free_slot_lookup(alive)
    sel_rank = torch.where(sel, torch.cumsum(sel.to(torch.int64), 0) - 1, m)
    dest = torch.where(sel & (sel_rank < num_free),
                       inv[torch.clamp(sel_rank, 0, m - 1)], m)
    ok = dest < m
    # sources are selected (live, bound) nodes, destinations free slots
    params.nodes[dest[ok]] = avg_x[ok]
    params.node_radius[dest[ok]] = params.node_radius[ok]
    params.node_weight[dest[ok]] = params.node_weight[ok]
    alive[dest[ok]] = True
    params.alive.copy_(alive)
    for moments in (mu, nu):
        for v in moments.values():
            v[dest[ok]] = 0.0
    return dict(added=torch.sum(ok), pruned=torch.sum(prune))
