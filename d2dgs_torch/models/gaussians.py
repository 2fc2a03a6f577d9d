"""Canonical Gaussian point-cloud state (counterpart of
d2dgs_tpu/models/gaussians.py, the reference's GaussianModel).

Arrays are padded to a fixed ``capacity`` with an ``alive`` mask, so the
state compares slot by slot with the JAX package's.  Parameters are raw
(pre-activation); activations are applied by the ``get_*`` views.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.knn import mean_knn_sq_dist
from ..utils.general import inverse_sigmoid, resolve_device
from ..utils.quaternion import quat_normalize
from ..utils.sh import rgb_to_sh


class GaussianParams(nn.Module):
    """xyz [C,3], features_dc [C,1,3], features_rest [C,(d+1)^2-1,3],
    scaling [C,2] log-scale (2D surfel), rotation [C,4] raw wxyz,
    opacity [C,1] logit, feature [C,F] hyper coords (+ motion-mask logit
    last); alive [C] bool buffer."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, feature, alive, active_sh_degree: int = 0,
                 with_motion_mask: bool = True):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)
        self.feature = nn.Parameter(feature)
        self.register_buffer("alive", alive)
        self.active_sh_degree = int(active_sh_degree)
        self.max_sh_degree = math.isqrt(features_rest.shape[1] + 1) - 1
        self.with_motion_mask = with_motion_mask

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self):
        return torch.sum(self.alive.to(torch.int32))

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def motion_mask(self):
        """[C,1] sigmoid of the last feature channel."""
        if self.with_motion_mask:
            return torch.sigmoid(self.feature[..., -1:])
        return torch.ones_like(self.xyz[..., :1])


def apply_deform(params: GaussianParams, d_xyz=0.0, d_rotation=0.0,
                 d_scaling=0.0, d_opacity=None, d_color=None):
    """Assemble rasterizer inputs from canonical params + deformation
    deltas.  Returns (means3d [C,3], scales [C,2], quats [C,4],
    opacity [C], sh [C,K,3]); dead slots carry opacity 0."""
    means3d = params.xyz + d_xyz
    scales = params.get_scaling + d_scaling
    quats = quat_normalize(params.rotation + d_rotation, eps=1e-12)
    opacity = params.get_opacity
    if d_opacity is not None:
        opacity = opacity + d_opacity
    opacity = torch.where(params.alive[:, None], opacity, 0.0)[:, 0]
    if d_color is not None:
        dc = params.features_dc + (0.0 + d_color)[:, None, :]
        sh = torch.cat([dc, params.features_rest], dim=1)
    else:
        sh = params.get_features
    return means3d, scales, quats, opacity, sh


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    sh_degree: int = 3, fea_dim: int = 8,
                    with_motion_mask: bool = True,
                    device="cuda") -> GaussianParams:
    """Initialize from a point cloud (gaussian_model.py:145-180): scales
    from the 3-NN mean squared distance, identity rotation, opacity 0.1,
    feature -1e-2 (motion-mask logit 0)."""
    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp_min(mean_knn_sq_dist(pts), 1e-7)
    scale = 0.5 * torch.log(dist2)  # log(sqrt(dist2))

    def pad(x, shape_tail):
        out = torch.zeros((capacity,) + shape_tail, dtype=torch.float32,
                          device=dev)
        out[:n] = x
        return out

    fdim = fea_dim + (1 if with_motion_mask else 0)
    feature = torch.full((capacity, fdim), -1e-2, dtype=torch.float32,
                         device=dev)
    if with_motion_mask:
        feature[:, -1] = 0.0
    rgb = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    rotation = torch.zeros((capacity, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0
    alive = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    alive[:n] = True
    op = inverse_sigmoid(0.1).to(dev)
    return GaussianParams(
        xyz=pad(pts, (3,)),
        features_dc=pad(rgb_to_sh(rgb)[:, None, :], (1, 3)),
        features_rest=torch.zeros((capacity, k - 1, 3), dtype=torch.float32,
                                  device=dev),
        scaling=pad(scale[:, None].expand(n, 2), (2,)),
        rotation=rotation,
        opacity=pad(op.expand(n, 1), (1,)),
        feature=feature, alive=alive, active_sh_degree=0,
        with_motion_mask=with_motion_mask)
