"""The HexPlane field (``deform_type`` "hexplane") of 4D Gaussian
Splatting (Wu et al., CVPR 2024, arXiv:2310.08528; hustvl/4DGaussians
``scene/hexplane.py``, ``scene/deformation.py``, ``scene/regulation.py``)
at its D-NeRF settings (``arguments/dnerf/dnerf_default.py``), queried at
every slot.  Per surfel at time t:

    q = (x - aabb[0]) * 2 / (aabb[1] - aabb[0]) - 1,  aabb = [max, min]
    p = [q, t]
    f_s = the product, over the six coordinate pairs (c0, c1) of
          combinations(range(4), 2), of plane (c0, c1) of scale s
          ([32, res(c1), res(c0)]) sampled bilinearly at (p[c0], p[c1]),
          align_corners, border;  f = [f_1, f_2]      64 wide
    h = Linear(64, 64)(f)                             feature_out
    d_xyz, d_scaling, d_rotation = ReLU, Linear 64->64, ReLU, Linear 64->k

and the loss gains 4DGS's plane regulariser

    R = plane_tv_weight * sum_spatial S(P) + time_smoothness_weight
        * sum_time S(P) + l1_time_planes * sum_time mean |1 - P|

where S(P) is the mean square of P's second difference along its height,
one mean per plane.  ``reference.train_loss`` has no field term, so R
enters as its gradient: d_xyz passes through an autograd function that
is the identity forward and whose backward adds dR/dP to the planes,
which is the gradient of L + R.

The bilinear samples are computed here by explicit corner gathers and
weights (the border clamp and the align_corners map (c + 1) / 2 *
(size - 1)), not by ``F.grid_sample``, so the port and this reference
share no sampler.  The planes' leaves are as the port holds them: each
scale's three spatial planes ((x,y), (x,z), (y,z)) stacked as
``grids.<s>.space`` and its three time planes ((x,t), (y,t), (z,t)) as
``grids.<s>.time``.

Departures from 4DGS, each as the port has it:

- the scaling head emits the surfel's 2 scales (4DGS: 3);
- ``x`` is detached, as the port's facade passes it to every field;
- the planes train at the field group's one learning-rate schedule
  (``reference.lr_of``; 4DGS gives the grid ten times the MLP's rate);
- the aabb is the scene's surfels' (``scene.load_surfels``), where 4DGS
  takes its initial point cloud's;
- weights are [fan_in, fan_out], applied as ``h @ w + b``;
- the weights are drawn as a trained field's: the planes uniform in
  +-``plane_init`` (4DGS starts the spatial planes in U(0.1, 0.5) and
  the time planes at ones, so nothing would move with t), the layers
  Xavier-uniform with ``nn.Linear``'s biases, the heads' last layers
  normal at ``head_std`` with zero biases;
- every capacity slot is evaluated, dead ones included; the renderer
  gives dead slots no opacity;
- no opacity or colour heads (``no_do``, ``no_dshs``, as the D-NeRF
  settings have them).
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from ..scene import load_surfels
from . import dense_ops

HEADS = (("pos_deform", 3), ("scales_deform", 2), ("rotations_deform", 4))
# each coordinate pair's plane: (leaf, index in the stack)
PLANE_OF = {(0, 1): ("space", 0), (0, 2): ("space", 1), (1, 2): ("space", 2),
            (0, 3): ("time", 0), (1, 3): ("time", 1), (2, 3): ("time", 2)}
# float operations of one bilinear sample per channel (4 products, 3
# sums) and of a scale's product of six samples per channel
OPS_BLEND = 7
OPS_PRODUCT = 5


def samples_per_row(cfg: dict) -> int:
    """Planes sampled a row: six a scale."""
    return 6 * len(cfg["multires"])


def _dims(cfg: dict) -> list:
    """(fan_in, fan_out) of feature_out's and the heads' products."""
    W = cfg["net_width"]
    feat = cfg["kplanes_config"]["output_coordinate_dim"] * len(
        cfg["multires"])
    dims = [(feat, W)]
    for _, k in HEADS:
        dims += [(W, W), (W, k)]
    return dims


def plane_shapes(cfg: dict) -> list:
    """(name, [3, C, H, W]) of the stacked plane leaves, by scale: each
    plane is [C, res(c1), res(c0)], the spatial resolutions times the
    scale's multiplier."""
    kp = cfg["kplanes_config"]
    C, res = kp["output_coordinate_dim"], kp["resolution"]
    if len(set(res[:3])) != 1:
        raise ValueError("spatial planes of unequal sizes cannot be stacked")
    out = []
    for s, m in enumerate(cfg["multires"]):
        r = res[0] * m
        out += [(f"grids.{s}.space", (3, C, r, r)),
                (f"grids.{s}.time", (3, C, res[3], r))]
    return out


def shapes(cfg: dict) -> list:
    out = [(name, shape, "u", cfg["plane_init"])
           for name, shape in plane_shapes(cfg)]
    dims = _dims(cfg)
    fan, W = dims[0]
    out += [("feature_out.w", (fan, W), "u", math.sqrt(6 / (fan + W))),
            ("feature_out.b", (W,), "u", 1 / math.sqrt(fan))]
    for name, k in HEADS:
        out += [(f"{name}.w0", (W, W), "u", math.sqrt(6 / (2 * W))),
                (f"{name}.b0", (W,), "u", 1 / math.sqrt(W)),
                (f"{name}.w1", (W, k), "n", cfg["head_std"][name]),
                (f"{name}.b1", (k,), "0", 0.0)]
    return out


def extra_state(cfg: dict, gauss: dict, n: int, seeds: dict, device):
    return None


@functools.lru_cache(maxsize=8)
def aabb(scene: str) -> np.ndarray:
    """[xyz_max, xyz_min] of the scene's surfels (``set_aabb``)."""
    xyz = np.asarray(load_surfels({"scene": scene})[0], np.float32)
    return np.stack([xyz.max(0), xyz.min(0)])


def bilinear(plane, u, v):
    """[N, C]: ``plane`` [C, H, W] sampled at (u, v) in [-1, 1] (u along
    the width), bilinearly, with the align_corners map and the border
    clamp, by gathering the four corners."""
    C, H, W = plane.shape
    ix = torch.clamp((u + 1.0) / 2.0 * (W - 1), 0.0, W - 1.0)
    iy = torch.clamp((v + 1.0) / 2.0 * (H - 1), 0.0, H - 1.0)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0)[:, None], (iy - y0)[:, None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    rows = plane.permute(1, 2, 0).reshape(H * W, C)
    at = lambda yy, xx: torch.index_select(rows, 0, yy * W + xx)
    return (at(y0, x0) * ((1.0 - wx) * (1.0 - wy))
            + at(y0, x1) * (wx * (1.0 - wy))
            + at(y1, x0) * ((1.0 - wx) * wy)
            + at(y1, x1) * (wx * wy))


def features(field: dict, cfg: dict, x, t):
    """[N, 64]: each scale's product of its six plane samples, in
    combinations(range(4), 2) order, the scales concatenated."""
    box = torch.as_tensor(aabb(cfg["scene"]), device=x.device)
    q = (x - box[0]) * (2.0 / (box[1] - box[0])) - 1.0
    tt = torch.as_tensor(t, dtype=torch.float32,
                         device=x.device).reshape(1, 1).expand(x.shape[0], 1)
    p = torch.cat([q, tt], dim=-1)
    out = []
    for s in range(len(cfg["multires"])):
        f = None
        for c0, c1 in itertools.combinations(range(4), 2):
            leaf, k = PLANE_OF[(c0, c1)]
            smp = bilinear(field[f"grids.{s}.{leaf}"][k], p[:, c0], p[:, c1])
            f = smp if f is None else f * smp
        out.append(f)
    return torch.cat(out, dim=-1)


def smoothness(plane):
    """``compute_plane_smoothness`` of one plane [C, H, W]: the mean
    square of its second difference along the height."""
    first = plane[:, 1:, :] - plane[:, :-1, :]
    second = first[:, 1:, :] - first[:, :-1, :]
    return torch.mean(torch.square(second))


def regulariser(field: dict, cfg: dict):
    """4DGS's ``compute_regulation`` at the configuration's weights,
    plane by plane."""
    space = time = l1 = 0.0
    for s in range(len(cfg["multires"])):
        for k in range(3):
            sp = field[f"grids.{s}.space"][k]
            tp = field[f"grids.{s}.time"][k]
            space = space + smoothness(sp)
            time = time + smoothness(tp)
            l1 = l1 + torch.mean(torch.abs(1.0 - tp))
    return (cfg["plane_tv_weight"] * space
            + cfg["time_smoothness_weight"] * time
            + cfg["l1_time_planes"] * l1)


class WithRegulariser(torch.autograd.Function):
    """The identity on ``d_xyz``; its backward also returns dR/dP for the
    planes ``names`` (``regulariser``), so that a loss of d_xyz gets the
    gradient of loss + R."""

    @staticmethod
    def forward(ctx, d_xyz, cfg, names, *planes):
        ctx.cfg, ctx.names = cfg, names
        ctx.save_for_backward(*planes)
        return d_xyz.clone()

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            planes = [p.detach().requires_grad_(True)
                      for p in ctx.saved_tensors]
            grads = torch.autograd.grad(
                regulariser(dict(zip(ctx.names, planes)), ctx.cfg), planes)
        return (g, None, None, *grads)


def hexplane_field(field: dict, cfg: dict, x, t):
    """(d_xyz, d_rotation, d_scaling) of the field at ``x`` [N, 3] and
    time ``t``, d_xyz carrying R's gradient."""
    h = features(field, cfg, x.detach(), t) @ field["feature_out.w"] + \
        field["feature_out.b"]

    def head(name):
        hid = torch.relu(torch.relu(h) @ field[f"{name}.w0"]
                         + field[f"{name}.b0"])
        return hid @ field[f"{name}.w1"] + field[f"{name}.b1"]

    names = tuple(name for name, _ in plane_shapes(cfg))
    d_xyz = WithRegulariser.apply(head("pos_deform"), cfg, names,
                                  *(field[n] for n in names))
    return d_xyz, head("rotations_deform"), head("scales_deform")


def forward(state: dict, cfg: dict, t, step):
    return hexplane_field(state["field"], cfg, state["gauss"]["xyz"], t)


def sample_ops(cfg: dict, rows: int) -> float:
    """The plane sampling's forward operations: per row, 12 bilinear
    blends of 32 channels and the two scales' products."""
    C = cfg["kplanes_config"]["output_coordinate_dim"]
    return float(rows) * C * (samples_per_row(cfg) * OPS_BLEND
                              + len(cfg["multires"]) * OPS_PRODUCT)


def fwd_ops(cfg: dict, n_live: int) -> tuple[float, float]:
    """The sampling, the products and the MLP per surfel, all
    differentiated."""
    return sample_ops(cfg, n_live) + dense_ops(n_live, _dims(cfg)), 0.0


def sample_work(cfg: dict, rows: float) -> dict:
    """The least work of the plane sampling of ``rows`` rows, forward and
    backward: every plane value read once and its gradient written once,
    each row's four coordinates read and its 64 features written, their
    gradient read; the operations of ``sample_ops`` (the backward's
    arithmetic is left out: the bytes bound it)."""
    feat = cfg["kplanes_config"]["output_coordinate_dim"] * len(
        cfg["multires"])
    planes = sum(math.prod(shape) for _, shape in plane_shapes(cfg))
    nbytes = 4.0 * (2 * planes + rows * (4 + 2 * feat))
    return {"ops": sample_ops(cfg, rows), "bytes": nbytes}
