"""Exact k-nearest-neighbour ops (counterpart of d2dgs_tpu/ops/knn.py).

Selection uses the expanded |x|^2 + |y|^2 - 2 x.y distances (one matmul
per query chunk); the returned distances are recomputed exactly as
|q - r|^2 on the selected pairs, which removes the expanded form's
float32 cancellation residue.
"""
from __future__ import annotations

import torch


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        query_chunk: int = 4096, exclude_self: bool = False):
    """query [Q,D], ref [M,D] -> (sq_dists [Q,k], idx [Q,k] int64), ascending.

    exclude_self: query IS ref (same indexing); the diagonal is masked.
    """
    q = query.shape[0]
    m = ref.shape[0]
    ref_sq = torch.sum(ref * ref, dim=-1)                      # [M]
    cols = torch.arange(m, device=ref.device)
    d2_out, idx_out = [], []
    for row0 in range(0, q, query_chunk):
        qrows = query[row0:row0 + query_chunk]
        d2 = (torch.sum(qrows * qrows, dim=-1, keepdim=True)
              + ref_sq[None, :] - 2.0 * (qrows @ ref.T))
        if exclude_self:
            rows = row0 + torch.arange(qrows.shape[0], device=ref.device)
            d2 = torch.where(rows[:, None] == cols[None, :],
                             torch.full_like(d2, float("inf")), d2)
        idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True).indices
        diff = qrows[:, None, :] - ref[idx]                     # [C,k,D]
        d2_out.append(torch.sum(diff * diff, dim=-1))
        idx_out.append(idx)
    d2 = torch.cat(d2_out)
    return torch.clamp_min(d2, 0.0), torch.cat(idx_out)


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     query_chunk: int = 4096) -> torch.Tensor:
    """distCUDA2 equivalent: mean squared distance to the k nearest
    *other* points."""
    d2, _ = knn(points, points, k, query_chunk=query_chunk,
                exclude_self=True)
    return torch.mean(d2, dim=-1)
