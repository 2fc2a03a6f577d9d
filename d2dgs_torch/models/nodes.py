"""Sparse-control-node deformation (counterpart of d2dgs_tpu/models/nodes.py,
the reference's ControlNodeWarp, utils/time_utils.py:770-1387).

M control nodes carry (xyz + hyper coords), a log radius and a weight
logit.  A Gaussian's deformation is the KNN(K=3)-weighted blend of the
per-node MLP deltas, gated by its motion mask; the KNN runs in
(xyz + hyper) space with Gaussian-kernel weights exp(-d^2 / 2r^2) * w_node.
Nodes are capacity-padded with an ``alive`` mask (dead nodes are at
+inf distance).  Only linear-blend skinning (plain and local-frame) is
ported; dual-quaternion blending waits (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..utils.general import farthest_point_sample, resolve_device
from ..utils.quaternion import quat_to_rotmat
from .deform_mlp import MLPConfig, init_mlp, mlp_forward

ROT_BIAS = (1.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    node_num: int = 512          # capacity M
    K: int = 3
    hyper_dim: int = 8
    d_rot_as_res: bool = True
    with_node_weight: bool = True
    # "lbs": linear blend of per-node transforms; "dqb" (dual-quaternion
    # blend) is not ported yet
    skinning: str = "lbs"
    # float32 KNN membership selection; False selects on a bfloat16 copy
    # of the distances exactly as the JAX package does (only near-tie
    # memberships differ from the float32 selection)
    exact_knn: bool = False
    mlp: MLPConfig = MLPConfig()


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
                  feature: torch.Tensor | None, K: int | None = None):
    """Gaussian->node binding weights (time_utils.py:934-967).

    x: [N,3] (detached inside); feature: [N,hyper] learnable hyper coords.
    Returns (weight [N,K], dist2 [N,K], idx [N,K] int64).
    """
    K = cfg.K if K is None else K
    q = x.detach()
    ref = params.nodes[:, :3].detach()
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
            d2_sel[rows, i] = float("inf")
        idx = torch.stack(idxs, dim=-1)                       # [N,K]
    # differentiable distances recomputed only at the K selected nodes
    d_dim = ref.shape[-1]
    pack = torch.cat([ref, torch.exp(params.node_radius)[:, None],
                      params.node_weight], dim=-1)          # [M, D+2]
    pk = pack[idx]                                          # [N,K,D+2]
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
    if cfg.mlp.local_frame and cfg.skinning == "dqb":
        raise NotImplementedError(
            "dual-quaternion skinning is not ported yet (ROADMAP.md)")
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
    if cfg.mlp.local_frame:
        # rigid local frames: A_k(x) = R_k (x - p_k) + p_k + tr_k factors
        # as (sum_k w R_k) x + sum_k w_k v_k, v_k = p_k + tr_k - R_k p_k
        bias = torch.tensor(ROT_BIAS, device=x.device)
        Rl = quat_to_rotmat(attrs["local_rotation"] + bias)    # [M,3,3]
        p = params.nodes[:, :3].detach()
        v = p + node_trans - torch.einsum("mij,mj->mi", Rl, p)
        cols = [Rl.reshape(m, 9), v] + cols[1:]   # node_trans folded into v

    # K-row gather blend (the JAX package's dense [N, M] Wmat matmul is a
    # TPU layout choice): blended[n] = sum_k w[n,k] * cols[idx[n,k]]
    widths = [c.shape[-1] for c in cols]
    table = torch.cat(cols, dim=-1)                          # [M, sum(C)]
    blended = torch.sum(nn_weight[..., None] * table[nn_idx], dim=1)
    parts = torch.split(blended, widths, dim=-1)

    if cfg.mlp.local_frame:
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
        rotation = rot_b * motion_mask + torch.tensor(ROT_BIAS,
                                                      device=x.device)
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
