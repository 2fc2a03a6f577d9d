"""HexPlane deformation field of 4D Gaussian Splatting (Wu et al., CVPR
2024, arXiv:2310.08528; hustvl/4DGaussians ``scene/hexplane.py``
``HexPlaneField``, ``scene/deformation.py`` ``Deformation``,
``scene/regulation.py``), with its D-NeRF settings
(``arguments/dnerf/dnerf_default.py``) as the defaults.

Per surfel at time t:

    q = (x - aabb[0]) * 2 / (aabb[1] - aabb[0]) - 1,  aabb = [max, min]
    p = [q, t]                                  t in [0, 1], as given
    per scale s: the product of six bilinear samples (align_corners,
        border) of [32, res(c1), res(c0)] planes at (p[c0], p[c1]), one
        per coordinate pair in ``itertools.combinations(range(4), 2)``
        order; spatial resolution 64 s, time resolution 25
    f = [f_1, f_2]                              64 wide
    h = Linear(64, 64)(f)                       feature_out, defor_depth 0
    d_xyz, d_scaling, d_rotation = ReLU, Linear 64->64, ReLU, Linear 64->k

Each scale keeps its three spatial planes ((x,y), (x,z), (y,z)) as one
``[3, 32, r, r]`` leaf and its three time planes ((x,t), (y,t), (z,t))
as one ``[3, 32, 25, r]`` leaf, so a scale is two ``F.grid_sample``
calls.  The parameters are an ``nn.ModuleDict`` ("grids.0.space",
"grids.0.time", "feature_out.w", "pos_deform.w0", ...; weights
[fan_in, fan_out], applied as ``h @ w + b``) with the ``aabb`` as a
buffer, set from the point cloud.

Departures from 4DGS, as the port's facade has them for every field:
the scaling head emits the surfel's 2 scales; ``x`` arrives detached;
the planes train at the field group's one learning-rate schedule (4DGS
gives the grid ten times the MLP's rate); no opacity or colour heads
(``no_do``, ``no_dshs``, as the D-NeRF settings have them).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import trace
from ..utils.general import resolve_device
from .deform_mlp import mlp_from_arrays

# the coordinate pairs of each stacked leaf, in combinations(range(4), 2)
# order: the spatial planes are combinations 0, 1, 3 and the time planes
# 2, 4, 5
SPACE_PAIRS = ((0, 1), (0, 2), (1, 2))
TIME_PAIRS = ((0, 3), (1, 3), (2, 3))
HEADS = (("pos_deform", 3), ("scales_deform", 2), ("rotations_deform", 4))


@dataclasses.dataclass(frozen=True)
class HexPlaneConfig:
    """4DGS's ``kplanes_config`` (2-D planes over 4 input coordinates:
    ``output_coordinate_dim``, ``resolution``), ``multires``,
    ``defor_depth``, ``net_width``, ``bounds`` and the planes'
    regulariser weights."""
    output_coordinate_dim: int = 32
    resolution: tuple = (64, 64, 64, 25)
    multires: tuple = (1, 2)
    defor_depth: int = 0
    net_width: int = 64
    bounds: float = 1.6          # the aabb until a point cloud sets it
    plane_tv_weight: float = 1e-4
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 1e-4

    def plane_shapes(self, scale: int) -> tuple:
        """[3, C, H, W] of a scale's spatial and time leaves: each plane
        is [C, res(c1), res(c0)], spatial resolutions times ``scale``."""
        c = self.output_coordinate_dim
        r = self.resolution[0] * scale
        return (3, c, r, r), (3, c, self.resolution[3], r)

    @property
    def feat_dim(self) -> int:
        return self.output_coordinate_dim * len(self.multires)


def init_hexplane_deform(cfg: HexPlaneConfig,
                         generator: torch.Generator | None = None,
                         device="cuda", init_pcl=None) -> nn.ModuleDict:
    """4DGS's initialisation, drawn on the CPU from ``generator``, then
    moved to ``device``: spatial planes U(0.1, 0.5), time planes ones
    (``init_grid_param``), Xavier-uniform weights and ``nn.Linear``'s
    biases (``initialize_weights``).  The aabb is ``init_pcl``'s, or
    +-``bounds`` without one."""
    if cfg.defor_depth > 1:
        raise ValueError("the port builds feature_out for defor_depth 0 or "
                         f"1 (one Linear), got {cfg.defor_depth}")
    dev = resolve_device(device)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    def linear(fan_in, fan_out):
        w = math.sqrt(6.0 / (fan_in + fan_out))
        b = 1.0 / math.sqrt(fan_in)
        return uni((fan_in, fan_out), -w, w), uni((fan_out,), -b, b)

    grids = []
    for s in cfg.multires:
        space, time = cfg.plane_shapes(s)
        grids.append({"space": uni(space, 0.1, 0.5),
                      "time": torch.ones(time)})
    W = cfg.net_width
    w, b = linear(cfg.feat_dim, W)
    tree = {"grids": grids, "feature_out": {"w": w, "b": b}}
    for name, k in HEADS:
        w0, b0 = linear(W, W)
        w1, b1 = linear(W, k)
        tree[name] = {"w0": w0, "b0": b0, "w1": w1, "b1": b1}
    params = mlp_from_arrays(tree, dev)
    if init_pcl is None:
        bound = torch.full((3,), float(cfg.bounds))
        aabb = torch.stack([bound, -bound])
    else:   # HexPlaneField.set_aabb: [xyz_max, xyz_min]
        pts = torch.as_tensor(np.asarray(init_pcl, np.float32))
        aabb = torch.stack([pts.amax(0), pts.amin(0)])
    params.register_buffer("aabb", aabb.to(dev))
    return params


def _coords(p: torch.Tensor, pairs) -> torch.Tensor:
    """[3, 1, N, 2] sample points of three planes: (p[c0], p[c1]) each,
    x indexing the width (res(c0)) and y the height (res(c1))."""
    cols = [p[:, c] for pair in pairs for c in pair]
    return torch.stack(cols, 0).reshape(3, 2, 1, -1).permute(0, 2, 3, 1)


def _sample(planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """[3, C, N]: the three stacked planes sampled bilinearly at their
    points (``grid_sample_wrapper``)."""
    return F.grid_sample(planes, coords, mode="bilinear",
                         padding_mode="border", align_corners=True)[:, :, 0]


def hexplane_features(params: nn.ModuleDict, x: torch.Tensor,
                      t) -> torch.Tensor:
    """[N, feat_dim]: the scales' plane products at ``x`` [N, 3] and time
    ``t`` (a scalar or [N, 1]), concatenated (``interpolate_ms_features``
    with ``concat_features``)."""
    aabb = params.aabb
    q = (x - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0
    tt = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    tt = tt.reshape(-1, 1).expand(x.shape[0], 1)
    p = torch.cat([q, tt], dim=-1)
    space_at, time_at = _coords(p, SPACE_PAIRS), _coords(p, TIME_PAIRS)
    feats = []
    for grid in params["grids"]:
        s = _sample(grid["space"], space_at)
        m = _sample(grid["time"], time_at)
        # the product in 4DGS's plane order: (x,y) (x,z) (x,t) (y,z)
        # (y,t) (z,t)
        feats.append((s[0] * s[1] * m[0] * s[2] * m[1] * m[2]).t())
    return torch.cat(feats, dim=-1)


def hexplane_forward(params: nn.ModuleDict, cfg: HexPlaneConfig,
                     x: torch.Tensor, t) -> dict:
    """x: [N, 3] canonical positions; t: scalar or [N, 1] in [0, 1].
    Returns d_xyz [N, 3], d_rotation [N, 4], d_scaling [N, 2].

    The sampling, the products and the MLP are the ``d2dgs.hexplane``
    span; under a profiler ``field.plane_samples`` counts rows x 12 (the
    planes sampled a row), from the shapes."""
    with trace.span("d2dgs.hexplane"):
        trace.count("field.plane_samples",
                    x.shape[0] * 6 * len(cfg.multires))
        fo = params["feature_out"]
        h = hexplane_features(params, x, t) @ fo["w"] + fo["b"]

        def head(name):
            p = params[name]
            hid = torch.relu(torch.relu(h) @ p["w0"] + p["b0"])
            return hid @ p["w1"] + p["b1"]

        return {"d_xyz": head("pos_deform"),
                "d_rotation": head("rotations_deform"),
                "d_scaling": head("scales_deform")}


def plane_smoothness(planes: torch.Tensor) -> torch.Tensor:
    """``compute_plane_smoothness`` summed over a stacked leaf's planes:
    the mean square of each plane's second difference along its height,
    one mean per plane."""
    first = planes[..., 1:, :] - planes[..., :-1, :]
    second = first[..., 1:, :] - first[..., :-1, :]
    return planes.shape[0] * torch.mean(torch.square(second))


def plane_regulariser(params: nn.ModuleDict,
                      cfg: HexPlaneConfig) -> torch.Tensor:
    """4DGS's ``compute_regulation``: plane_tv_weight x the spatial
    planes' smoothness + time_smoothness_weight x the time planes'
    smoothness (along time) + l1_time_planes x the time planes' mean
    |1 - P|, each summed over the planes of both scales."""
    space = time = l1 = 0.0
    for grid in params["grids"]:
        space = space + plane_smoothness(grid["space"])
        time = time + plane_smoothness(grid["time"])
        m = grid["time"]
        l1 = l1 + m.shape[0] * torch.mean(torch.abs(1.0 - m))
    return (cfg.plane_tv_weight * space + cfg.time_smoothness_weight * time
            + cfg.l1_time_planes * l1)
