"""LapDeform facade: handle-based editing of the control-node cloud
(counterpart of d2dgs_tpu/edit/lap_deform.py, the reference's
lap_deform.py:96-226 and its utils/arap_deform.py deformer).

Holds the rest-pose editing graph over the control nodes (optionally
masked to a subset) and exposes:
  * ``deform(handle_idx, handle_pos)``      — Laplacian editing (one solve);
  * ``deform_arap(handle_idx, handle_pos)`` — the ARAP local-global loop,
    with per-node rotations as quaternions;
  * ``estimate_R(pcl)``                     — best-fit per-node rotations;
  * ``energy(pcl)`` / ``energy_arap``       — the editing energies;
  * ring expansion for handle selection.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.general import resolve_device
from ..utils.quaternion import rotmat_to_quat
from .arap import (ArapGraph, _fit_rotations, _solve_with_handles,
                   arap_deform, build_graph, deform_energy)


class LapDeform:
    def __init__(self, init_pcl, K: int = 4, point_mask=None,
                 node_radius: float | None = None, device="cuda"):
        self.device = resolve_device(device)
        init_pcl = torch.as_tensor(init_pcl, dtype=torch.float32,
                                   device=self.device)
        self.point_mask = (None if point_mask is None
                           else np.asarray(point_mask, bool))
        pcl = (init_pcl if self.point_mask is None else init_pcl[
            torch.as_tensor(np.where(self.point_mask)[0],
                            device=self.device)])
        self.graph: ArapGraph = build_graph(pcl, K=K, radius=node_radius)
        self.N = int(pcl.shape[0])
        self.K = K

    # -- index bookkeeping -------------------------------------------------
    def world_2_local_index(self, idx):
        """Full-cloud indices -> masked-graph indices."""
        if self.point_mask is None:
            return np.asarray(idx, np.int64)
        lut = -np.ones(self.point_mask.shape[0], np.int64)
        lut[np.where(self.point_mask)[0]] = np.arange(self.N)
        out = lut[np.asarray(idx, np.int64)]
        if (out < 0).any():
            raise ValueError("handle outside the editable point mask")
        return out

    def _handle_arrays(self, handle_idx, handle_pos):
        handle_idx = self.world_2_local_index(handle_idx)
        mask = np.zeros(self.N, bool)
        mask[handle_idx] = True
        pos = np.zeros((self.N, 3), np.float32)
        pos[handle_idx] = np.asarray(handle_pos, np.float32)
        return (torch.as_tensor(mask, device=self.device),
                torch.as_tensor(pos, device=self.device))

    def add_one_ring_nbs(self, idxs):
        """Expand a handle index set by its 1-ring graph neighbourhood
        (lap_deform.py:148-155)."""
        idxs = np.atleast_1d(np.asarray(idxs, np.int64))
        nbr = self.graph.nbr.cpu().numpy()
        return np.unique(np.concatenate([idxs, nbr[idxs].reshape(-1)]))

    def add_n_ring_nbs(self, idxs, n: int = 2):
        for _ in range(n):
            idxs = self.add_one_ring_nbs(idxs)
        return idxs

    # -- solvers ------------------------------------------------------------
    @torch.no_grad()
    def deform(self, handle_idx, handle_pos):
        """Laplacian editing: one constrained solve L p' = L p
        (lap_deform.py:200-210)."""
        mask, pos = self._handle_arrays(handle_idx, handle_pos)
        g = self.graph
        return _solve_with_handles(g.L, g.L @ g.verts, mask, pos)

    def deform_arap(self, handle_idx, handle_pos, n_iters: int = 3,
                    return_R: bool = True):
        """ARAP local-global deformation (lap_deform.py:212-225).  Returns
        (p_prime, quats), or p_prime alone without ``return_R``."""
        mask, pos = self._handle_arrays(handle_idx, handle_pos)
        p_prime, quats = arap_deform(self.graph, mask, pos, n_iters=n_iters,
                                     return_quats=return_R)
        return (p_prime, quats) if return_R else p_prime

    @torch.no_grad()
    def estimate_R(self, pcl, return_quaternion: bool = True):
        """Best-fit per-node rotations of ``pcl`` against the rest pose
        (lap_deform.py:165-179)."""
        g = self.graph
        pcl = self._as_tensor(pcl)
        P = g.verts[:, None, :] - g.verts[g.nbr]
        P_prime = pcl[:, None, :] - pcl[g.nbr]
        R = _fit_rotations(P, P_prime, g.w)
        return rotmat_to_quat(R) if return_quaternion else R

    @torch.no_grad()
    def energy(self, pcl, prev_pcl=None):
        """Laplacian-coordinate preservation energy
        (lap_deform.py:180-190)."""
        g = self.graph
        rest = g.verts if prev_pcl is None else self._as_tensor(prev_pcl)
        lap0 = g.L @ rest
        lap1 = g.L @ self._as_tensor(pcl)
        return torch.sum((lap1 - lap0) ** 2)

    def energy_arap(self, pcl, prev_pcl=None):
        return deform_energy(self.graph, self._as_tensor(pcl),
                             None if prev_pcl is None
                             else self._as_tensor(prev_pcl))

    def _as_tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)
