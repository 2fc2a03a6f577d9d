"""As-rigid-as-possible handle-based deformation of the control nodes
(counterpart of d2dgs_tpu/edit/arap.py, the reference's ARAPDeformer,
utils/arap_deform.py:98-171): the Sorkine-Alexa local-global loop on a
KNN graph with Gaussian edge weights, per-node rotations fitted by SVD
(local step) and a weighted-Laplacian solve with the handles pinned
(global step).

The graph is node-sized (M ~ 512-1024), so the Laplacian is dense and
the global step is one ``torch.linalg.solve``; handles are pinned by
replacing their rows with identity rows.  A set of nodes that reaches no
handle leaves the system singular, as in the JAX package: no regulariser
is added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.knn import knn
from ..utils.quaternion import rotmat_to_quat


class ArapGraph(NamedTuple):
    verts: torch.Tensor   # [N,3] rest positions
    nbr: torch.Tensor     # [N,K] neighbour indices (int64)
    w: torch.Tensor       # [N,K] normalised edge weights
    L: torch.Tensor       # [N,N] weighted graph Laplacian


def build_graph(pcl: torch.Tensor, K: int = 4,
                radius: float | None = None) -> ArapGraph:
    """A directed KNN graph with Gaussian edge weights exp(-d^2 / 2r^2),
    normalised per vertex, and the row-stochastic Laplacian L = I - W
    (the reference's L_opt: rigid translation is a fixed point of the
    local-global loop)."""
    pcl = pcl.to(torch.float32)
    n = pcl.shape[0]
    d2, idx = knn(pcl, pcl, K, exclude_self=True)
    r2 = torch.mean(d2) + 1e-12 if radius is None else radius ** 2
    w = torch.exp(-d2 / (2.0 * r2))
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    W = torch.zeros((n, n), dtype=torch.float32, device=pcl.device)
    rows = torch.arange(n, device=pcl.device)[:, None].expand(n, K)
    W.index_put_((rows, idx), w, accumulate=True)
    L = torch.diag(W.sum(-1)) - W
    return ArapGraph(verts=pcl, nbr=idx, w=w, L=L)


def _solve_with_handles(L, b, handle_mask, handle_pos):
    """Solve L x = b with the handle rows replaced by x_h = p_h."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    A = torch.where(handle_mask[:, None], eye, L)
    rhs = torch.where(handle_mask[:, None], handle_pos, b)
    return torch.linalg.solve(A, rhs)


def _fit_rotations(P, P_prime, w):
    """Per-vertex SVD best-fit rotations of weighted edge sets
    (arap_deform.py:127-146), with the det < 0 fix: the column of U with
    the smallest singular value is negated.  An undeformed edge set gives
    the identity."""
    S = torch.einsum("nki,nk,nkj->nij", P, w, P_prime)
    U, sig, Vh = torch.linalg.svd(S)
    R = torch.einsum("nji,nkj->nik", Vh, U)    # V @ U^T
    det = torch.linalg.det(R)
    flip_col = torch.argmin(sig, dim=-1)
    sign = torch.ones_like(sig)
    sign[torch.arange(sig.shape[0], device=sig.device), flip_col] = \
        torch.where(det < 0, -1.0, 1.0)
    Rfix = torch.einsum("nji,nkj->nik", Vh, U * sign[:, None, :])
    R = torch.where((det < 0)[:, None, None], Rfix, R)
    undeformed = torch.all(torch.abs(P - P_prime) < 1e-12, dim=2).all(1)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.where(undeformed[:, None, None], eye[None], R)


@torch.no_grad()
def arap_deform(graph: ArapGraph, handle_mask: torch.Tensor,
                handle_pos: torch.Tensor, n_iters: int = 3,
                return_quats: bool = True):
    """Move graph.verts so the vertices of ``handle_mask`` [N] bool land at
    ``handle_pos`` [N,3] (other rows ignored), as rigidly as possible:
    the Laplacian-editing solve L p' = L p, then ``n_iters``
    local-global rounds (ARAPDeformer.deform).  Returns (new verts
    [N,3], quats [N,4] or None)."""
    verts, nbr, w, L = graph
    P = verts[:, None, :] - verts[nbr]            # [N,K,3] rest edges
    p_prime = _solve_with_handles(L, L @ verts, handle_mask, handle_pos)
    R = torch.eye(3, dtype=verts.dtype, device=verts.device).expand(
        verts.shape[0], 3, 3)
    for _ in range(n_iters):
        P_prime = p_prime[:, None, :] - p_prime[nbr]
        R = _fit_rotations(P, P_prime, w)
        Rsum = R[:, None] + R[nbr]                # [N,K,3,3]
        b = 0.5 * torch.einsum("nkij,nkj,nk->ni", Rsum, P, w)
        p_prime = _solve_with_handles(L, b, handle_mask, handle_pos)
    quats = rotmat_to_quat(R) if return_quats else None
    return p_prime, quats


@torch.no_grad()
def deform_energy(graph: ArapGraph, pcl: torch.Tensor,
                  prev_pcl: torch.Tensor | None = None) -> torch.Tensor:
    """ARAP energy of a deformed cloud against the rest graph
    (LapDeform.energy_arap, lap_deform.py:191-199): the weighted
    edge residual after best-fit rotations."""
    verts, nbr, w, _ = graph
    rest = verts if prev_pcl is None else prev_pcl
    P = rest[:, None, :] - rest[nbr]
    P_prime = pcl[:, None, :] - pcl[nbr]
    R = _fit_rotations(P, P_prime, w)
    res = P_prime - torch.einsum("nij,nkj->nki", R, P)
    return torch.sum(w * torch.sum(res * res, -1))
