"""Deformation-field regularizers (counterpart of
d2dgs_tpu/models/regularizers.py): ARAP, elastic and acceleration terms,
and the landmark loss-weight schedule.

Re-derivations of utils/deform_utils.py (cal_connectivity_from_points,
estimate_rotation, cal_arap_error) and the loss entries in
utils/time_utils.py:1080-1131.  Variable-length edge lists are dense
[M, K] neighbour tables with zero weights for dropped edges.  The random
draws (the time jitter, the sample times and, above ``sample_num`` nodes,
the Gumbel keys of the ARAP node sample) come from a ``torch.Generator``,
drawn once per term into ``ArapDraws`` (``arap_draws``) or ``TimeDraws``
(``time_draws``); tests fill them from the JAX package's draws instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..ops.knn import knn
from .nodes import NodeConfig, NodeParams, cal_nn_weight, node_deform


def landmark_interpolate(landmarks, steps, step, interpolation="log"):
    """Piecewise schedule of loss weights (time_utils.py:485-503), on the
    host in Python floats."""
    stage = int((step >= np.array(steps)).sum())
    if stage == len(steps):
        return max(0, landmarks[-1])
    if stage == 0:
        return 0
    ldm1, ldm2 = landmarks[stage - 1], landmarks[stage]
    if ldm2 <= 0:
        return 0
    s1, s2 = steps[stage - 1], steps[stage]
    ratio = (step - s1) / (s2 - s1)
    if interpolation == "log":
        return float(np.exp(np.log(ldm1) * (1 - ratio)
                            + np.log(ldm2) * ratio))
    return float(ldm1 * (1 - ratio) + ldm2 * ratio)


def _safe_norm(x, dim=-1, eps=1e-20):
    """||x|| with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


class TimeDraws(NamedTuple):
    u_t: torch.Tensor       # 0-d uniform: the time (or its jitter)
    u_samp: torch.Tensor    # [t_samp_num] uniforms: sample times


def time_draws(generator: torch.Generator | None,
               t_samp_num: int = 0) -> TimeDraws:
    """Draw an elastic (``t_samp_num`` 8) or acceleration (0) term's
    random numbers on the CPU from ``generator``."""
    return TimeDraws(torch.rand((), generator=generator),
                     torch.rand((t_samp_num,), generator=generator))


def _jittered_time(u_t, t, delta_t, like: torch.Tensor):
    """The term's time: ``u_t``, or ``t`` jittered by delta_t (u_t - 0.5);
    on the device and in the type of ``like``."""
    trace.count("host.reads", 1)  # the draw's copy from host memory
    u_t = u_t.to(like)
    if t is None:
        return u_t
    return torch.as_tensor(t).to(like).reshape(()) + delta_t * (u_t - 0.5)


class ArapDraws(NamedTuple):
    u_t: torch.Tensor               # 0-d uniform: the time (or its jitter)
    u_samp: torch.Tensor            # [t_samp_num] uniforms: sample times
    gumbel: torch.Tensor | None     # [M] Gumbel keys, when M > sample_num


def arap_draws(generator: torch.Generator | None, m: int,
               t_samp_num: int = 2, sample_num: int = 512) -> ArapDraws:
    """Draw an ARAP term's random numbers on the CPU from ``generator``."""
    u_t = torch.rand((), generator=generator)
    u_samp = torch.rand((t_samp_num,), generator=generator)
    gumbel = None
    if m > sample_num:
        u = torch.rand((m,), generator=generator)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return ArapDraws(u_t, u_samp, gumbel)


@torch.no_grad()
def connectivity_from_points(points: torch.Tensor, radius: float = 0.1,
                             K: int = 10, least_edge_num: int = 3):
    """KNN graph with a radius cutoff beyond the first ``least_edge_num``
    neighbours and adaptive weighting (deform_utils.py:59-115).
    Returns (nn_idx [M,K] int64, weight [M,K], keep [M,K] bool)."""
    d2, idx = knn(points, points, K, exclude_self=True)
    keep = torch.arange(K, device=points.device)[None, :] < least_edge_num
    keep = keep | (d2 < radius * radius)
    d2 = torch.where(keep, d2, float("inf"))
    scale = torch.mean(torch.where(torch.isfinite(d2), d2, 0.0))
    w = torch.where(keep, torch.exp(-d2 / scale), 0.0)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    return idx, w, keep


@torch.no_grad()
def _estimate_rotation_sampled(source, target, nn_idx_s, weight_s,
                               sample_idx):
    """Per-vertex weighted Procrustes rotations (deform_utils.py:131-167),
    det-flip corrected: target edges ~ R @ source edges.  R is taken
    without gradient, so the SVD's sign choice of paired singular vectors
    (which R = V U^T does not see) cannot matter."""
    E0 = source[nn_idx_s] - source[sample_idx][:, None]
    E1 = target[nn_idx_s] - target[sample_idx][:, None]
    S = torch.einsum("mka,mk,mkb->mab", E0, weight_s, E1)
    unchanged = torch.all(E0 == E1, dim=2).all(dim=1)
    S = torch.where(unchanged[:, None, None], 0.0, S)
    trace.count("host.reads", 2)  # linalg.svd reads back twice
    U, sig, Vh = torch.linalg.svd(S)
    V = Vh.transpose(-1, -2)
    R = V @ U.transpose(-1, -2)
    det = torch.linalg.det(R)
    col = torch.argmin(sig, dim=-1)
    flip = torch.where(torch.arange(3, device=S.device)[None, :]
                       == col[:, None], -1.0, 1.0)
    R_fix = V @ (U * flip[:, None, :]).transpose(-1, -2)
    return torch.where((det <= 0)[:, None, None], R_fix, R)


def estimate_rotation(source: torch.Tensor, target: torch.Tensor,
                      nn_idx: torch.Tensor, weight: torch.Tensor):
    """Per-vertex weighted Procrustes rotations of every vertex
    (deform_utils.py:131-167), det-flip corrected.  source/target: [M,3],
    nn_idx/weight: [M,K].  Returns R [M,3,3] with target edges ~ R @
    source edges."""
    return _estimate_rotation_sampled(
        source, target, nn_idx, weight,
        torch.arange(source.shape[0], device=source.device))


# ----------------------------------------------------------------------
# How far float32 may move the Procrustes rotations (the parity tests and
# chip_smoke.py hold estimate_rotation to it; not on the training path)
# ----------------------------------------------------------------------

# c of rotation_rounding_bound.  The polar factor of S moves by up to
# 2 |dS| / (s2 + s3) and float32 rounds S at ~eps s1, so c = 2 is the
# first-order size; 4 leaves room for the SVD's own rounding
# (tests/test_torch_tools.py::test_estimate_rotation_recovers_rigid gives
# the measured ratios).
ROTATION_ROUNDING_C = 4.0


def _np(x, dtype=np.float64) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=dtype)


def procrustes_covariance64(source, target, nn_idx, weight) -> np.ndarray:
    """``estimate_rotation``'s cross-covariance S [M,3,3] in float64
    (numpy) from the same float32 inputs (tensors or arrays), zero where
    no edge moved."""
    src, tgt, idx = _np(source), _np(target), _np(nn_idx, np.int64)
    E0 = src[idx] - src[:, None]
    E1 = tgt[idx] - tgt[:, None]
    S = np.einsum("mka,mk,mkb->mab", E0, _np(weight), E1)
    unchanged = np.all(E0 == E1, axis=(1, 2))
    return np.where(unchanged[:, None, None], 0.0, S)


def _svd_flip(S):
    """numpy's float64 SVD of S [M,3,3] as (U, sig, V) and where
    ``estimate_rotation``'s det fix flips (det V U^T <= 0)."""
    U, sig, Vh = np.linalg.svd(_np(S))
    V = np.swapaxes(Vh, -1, -2)
    flip = np.linalg.det(V @ np.swapaxes(U, -1, -2)) <= 0
    return U, sig, V, flip


def rotation_oracle(S) -> np.ndarray:
    """``estimate_rotation`` of each S [M,3,3] in float64: R = V U^T by
    numpy's SVD, the column of U of the smallest singular value negated
    where det R <= 0."""
    U, _, V, flip = _svd_flip(S)
    U[flip, :, 2] *= -1.0
    return V @ np.swapaxes(U, -1, -2)


def rotation_rounding_bound(S, c: float = ROTATION_ROUNDING_C) -> np.ndarray:
    """Per vertex, how far float32 may move ``estimate_rotation`` of S
    [M,3,3] from ``rotation_oracle(S)``: max(1e-5, c eps s1 / d) with
    eps = 2^-23, the float64 singular values s1 >= s2 >= s3 and d = s2 +
    s3, or s2 - s3 where the det fix flips (the fixed rotation is the
    polar factor of a matrix with singular values s1, s2, -s3).  Infinite
    where d is 0: S does not determine the rotation there."""
    _, sig, _, flip = _svd_flip(S)
    d = np.where(flip, sig[:, 1] - sig[:, 2], sig[:, 1] + sig[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        tol = np.where(d > 0, c * 2.0 ** -23 * sig[:, 0] / d, np.inf)
    return np.maximum(1e-5, tol)


def arap_energy(nodes_seq: torch.Tensor, nn_idx, weight, sample_idx=None):
    """cal_arap_error (deform_utils.py:177-207): sum over t>0 of weighted
    stretch ||E_t - R E_0||^2 with no-grad best-fit rotations.
    nodes_seq: [T, M, 3]."""
    src = nodes_seq[0]
    if sample_idx is not None:
        nn_idx_s = nn_idx[sample_idx]
        weight_s = weight[sample_idx]
    else:
        sample_idx = torch.arange(src.shape[0], device=src.device)
        nn_idx_s, weight_s = nn_idx, weight
    E0 = src[nn_idx_s] - src[sample_idx][:, None]
    total = torch.zeros((), dtype=src.dtype, device=src.device)
    for ti in range(1, nodes_seq.shape[0]):
        tgt = nodes_seq[ti]
        R = _estimate_rotation_sampled(src.detach(), tgt.detach(), nn_idx_s,
                                       weight_s, sample_idx)
        E1 = tgt[nn_idx_s] - tgt[sample_idx][:, None]
        stretch = E1 - torch.einsum("mab,mkb->mka", R, E0)
        total = total + torch.sum(weight_s * torch.sum(stretch ** 2, dim=-1))
    return total


def arap_loss(params: NodeParams, cfg: NodeConfig, draws: ArapDraws,
              t=None, delta_t: float = 0.05, t_samp_num: int = 2,
              sample_num: int = 512) -> torch.Tensor:
    """time_utils.py:1080-1089: sample ``t_samp_num`` times in a
    ``delta_t`` window, KNN graph (K=10) over the deformed nodes at the
    first sample, weighted stretch energy with frozen best-fit rotations.
    ``draws``: the term's random numbers, from ``arap_draws`` with the same
    ``t_samp_num`` and ``sample_num``."""
    return arap_energy(*arap_graph(params, cfg, draws, t, delta_t,
                                   t_samp_num, sample_num))


def arap_graph(params: NodeParams, cfg: NodeConfig, draws: ArapDraws,
               t=None, delta_t: float = 0.05, t_samp_num: int = 2,
               sample_num: int = 512):
    """``arap_loss``'s inputs to ``arap_energy``: (nodes_seq [T,M,3],
    nn_idx [M,K], weight [M,K], sample_idx [sample_num] or None)."""
    m = params.nodes.shape[0]
    dev = params.nodes.device
    t = _jittered_time(draws.u_t, t, delta_t, params.nodes)
    trace.count("host.reads", 1)  # the draws' copy from host memory
    t_samp = draws.u_samp.to(params.nodes) * delta_t + t \
        - 0.5 * delta_t
    tt = t_samp[None, :, None].expand(m, t_samp_num, 1)
    d_xyz = node_deform(params, cfg, tt)["d_xyz"]           # [M,T,3]
    nodes_t = params.nodes[:, None, :3].detach() + d_xyz
    nodes_seq = nodes_t.transpose(0, 1)                     # [T,M,3]

    # cal_arap_error is invoked WITHOUT the adaptive connectivity weights
    # (time_utils.py:1086): every surviving edge gets weight 1
    nn_idx, _, keep = connectivity_from_points(nodes_seq[0].detach(), K=10)
    alive = params.alive.to(torch.float32)
    weight = keep.to(torch.float32) * alive[nn_idx] * alive[:, None]
    sample_idx = None
    if m > sample_num:
        # live nodes without replacement (deform_utils.py:189-190 uses
        # randperm): Gumbel top-k restricted to alive slots
        trace.count("host.reads", 1)  # the keys' copy from host memory
        g = draws.gumbel.to(dev, torch.float32) + torch.where(
            params.alive, 0.0, float("-inf"))
        sample_idx = torch.topk(g, sample_num).indices
    return nodes_seq, nn_idx, weight, sample_idx


def elastic_loss(params: NodeParams, cfg: NodeConfig, draws: TimeDraws,
                 t=None, delta_t=0.005, K: int = 2,
                 t_samp_num: int = 8) -> torch.Tensor:
    """Edge-length variance over a short time window
    (time_utils.py:1091-1108).  ``draws``: from ``time_draws`` with the
    same ``t_samp_num``."""
    m = params.nodes.shape[0]
    t = _jittered_time(draws.u_t, t, delta_t, params.nodes)
    trace.count("host.reads", 1)  # the draws' copy from host memory
    t_samp = draws.u_samp.to(params.nodes) * delta_t + t \
        - 0.5 * delta_t
    tt = t_samp[None, :, None].expand(m, t_samp_num, 1)
    d_xyz = node_deform(params, cfg, tt)["d_xyz"]
    nodes_t = params.nodes[:, None, :3].detach() + d_xyz     # [M,T,3]
    xyz = params.nodes[:, :3].detach()
    nn_weight, _, nn_idx = cal_nn_weight(params, cfg, xyz,
                                         params.nodes[:, 3:], K=K + 1)
    nn_weight, nn_idx = nn_weight[:, 1:], nn_idx[:, 1:]     # drop self
    edge_t = _safe_norm(nodes_t[nn_idx] - nodes_t[:, None])  # [M,K,T]
    # centred two-pass variance, as jnp.var: the edge lengths vary by
    # ~1e-3 of their size over the window, and torch.var's backward loses
    # that difference (its float32 warp-head gradient was 6e-4 of the
    # largest entry from float64, against 2e-5 this way)
    dev_t = edge_t - torch.mean(edge_t, dim=2, keepdim=True)
    var = torch.sum(dev_t * dev_t, dim=2) / (t_samp_num - 1)
    var = var / (var.detach() + 1e-5)
    per_node = torch.sum(var * nn_weight, dim=1)
    return torch.mean(torch.where(params.alive, per_node, 0.0))


def acc_loss(params: NodeParams, cfg: NodeConfig, draws: TimeDraws,
             t=None, delta_t=0.005) -> torch.Tensor:
    """Second finite difference of the node trajectories
    (time_utils.py:1110-1120).  ``draws``: from ``time_draws`` (only
    ``u_t`` is read)."""
    m = params.nodes.shape[0]
    t = _jittered_time(draws.u_t, t, delta_t, params.nodes)
    ts = torch.stack([t - delta_t, t, t + delta_t])
    tt = ts[None, :, None].expand(m, 3, 1)
    d_xyz = node_deform(params, cfg, tt)["d_xyz"]
    nodes_t = params.nodes[:, None, :3].detach() + d_xyz
    acc = _safe_norm(nodes_t[:, 0] + nodes_t[:, 2] - 2 * nodes_t[:, 1])
    acc = acc / (acc.detach() + 1e-5)
    return torch.mean(torch.where(params.alive, acc, 0.0))
