"""The per-surfel MLP field (``deform_type`` "mlp"): Deformable 3D
Gaussians' DeformNetwork (Yang et al., CVPR 2024, arXiv:2309.13101), in
the D-2DGS reference ``utils/time_utils.py:208-459`` with the Blender
timenet, queried at every slot.  Per surfel at time t:

    x_emb = PE_10(x)                                  63 wide
    t_emb = Linear(256, 30)(relu(Linear(13, 256)(PE_6(t))))
    inp   = [x_emb, t_emb]                            93 wide
    h     = 8 ReLU layers of width 256, layer D/2 + 1's input [inp, h]
    d_xyz, d_scaling, d_rotation = the warp, scaling and rotation heads

Departures from the reference, each as the port has it:

- weights are [fan_in, fan_out] and applied as ``h @ w + b``, the
  transpose of ``nn.Linear``'s layout;
- the heads are drawn normal at the configuration's ``head_std`` with
  zero biases, so that the field moves the surfels as a trained one does
  (the reference starts them near zero);
- every capacity slot is evaluated, dead ones included, as the port
  does; the renderer gives dead slots no opacity, so they change nothing
  but the work;
- the local-frame head and the opacity and colour heads are off, as
  ``TrainConfig.deform_cfg`` sets them for this field.
"""
from __future__ import annotations

import math

import torch

from ..reference import positional_encoding
from . import dense_ops

HEADS = (("warp", 3), ("scaling", 2), ("rotation", 4))


def _dims(cfg: dict) -> list:
    """(fan_in, fan_out) of the timenet's, the trunk's and the heads'
    products."""
    t_raw = 1 + 2 * cfg["t_multires"]
    in_ch = 3 * (1 + 2 * cfg["multires_x"]) + cfg["time_out"]
    W, depth = cfg["deform_width"], cfg["deform_depth"]
    dims = [(t_raw, 256), (256, cfg["time_out"])]
    for i in range(depth):
        dims.append((in_ch if i == 0 else
                     W + in_ch if i - 1 == depth // 2 else W, W))
    return dims + [(W, dout) for _, dout in HEADS]


def shapes(cfg: dict) -> list:
    dims = _dims(cfg)
    t_raw, t_out = dims[0][0], dims[1][1]
    b0, b1 = 1 / math.sqrt(t_raw), 1 / math.sqrt(256)
    out = [("timenet.w0", (t_raw, 256), "u", b0),
           ("timenet.b0", (256,), "u", b0),
           ("timenet.w1", (256, t_out), "u", b1),
           ("timenet.b1", (t_out,), "u", b1)]
    for i, (fan, W) in enumerate(dims[2:2 + cfg["deform_depth"]]):
        out += [(f"layers.{i}.w", (fan, W), "u", math.sqrt(6 / fan)),
                (f"layers.{i}.b", (W,), "0", 0.0)]
    for name, dout in HEADS:
        out += [(f"{name}.w", (cfg["deform_width"], dout), "n",
                 cfg["head_std"][name]),
                (f"{name}.b", (dout,), "0", 0.0)]
    return out


def extra_state(cfg: dict, gauss: dict, n: int, seeds: dict, device):
    return None


def deform_network(p: dict, cfg: dict, x, t):
    """DeformNetwork with the Blender timenet at ``x`` [N, 3] and time
    ``t``: (d_xyz, d_rotation, d_scaling)."""
    n = x.shape[0]
    tt = torch.as_tensor(t, dtype=torch.float32,
                         device=x.device).reshape(1, 1).expand(n, 1)
    t_emb = positional_encoding(tt, cfg["t_multires"])
    t_emb = (torch.relu(t_emb @ p["timenet.w0"] + p["timenet.b0"])
             @ p["timenet.w1"] + p["timenet.b1"])
    inp = torch.cat([positional_encoding(x, cfg["multires_x"]), t_emb], -1)
    h, depth = inp, cfg["deform_depth"]
    for i in range(depth):
        h = torch.relu(h @ p[f"layers.{i}.w"] + p[f"layers.{i}.b"])
        if i == depth // 2 and i + 1 < depth:
            h = torch.cat([inp, h], dim=-1)
    head = lambda name: h @ p[f"{name}.w"] + p[f"{name}.b"]
    return head("warp"), head("rotation"), head("scaling")


def forward(state: dict, cfg: dict, t, step):
    return deform_network(state["field"], cfg,
                          state["gauss"]["xyz"].detach(), t)


def fwd_ops(cfg: dict, n_live: int) -> tuple[float, float]:
    """The timenet, the trunk and the heads per surfel, all
    differentiated."""
    return dense_ops(n_live, _dims(cfg)), 0.0
