"""Deformation MLP (counterpart of d2dgs_tpu/models/deform_mlp.py, the
reference's DeformNetwork, utils/time_utils.py:311-459).

NeRF-style MLP (D=8, W=256, skip at D/2) over positional encodings of
the canonical position and the timestamp.  For Blender/D-NeRF data a
small "timenet" compresses the time encoding to 30 dims.  Heads are
near-zero initialized so deformation starts at identity.

Parameters are an ``nn.ModuleDict`` laid out like the JAX package's
dict: ``layers[i]["w"]`` is [fan_in, width] (inputs times weights), so
weights carry across unchanged.  The products stay ``torch.matmul``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..utils.general import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    depth: int = 8
    width: int = 256
    multires_x: int = 10
    is_blender: bool = False
    local_frame: bool = False
    pred_opacity: bool = False
    pred_color: bool = False
    max_d_scale: float = -1.0
    time_out: int = 30
    # ProgressiveBandFrequency time annealing: sin/cos bands only (no
    # identity term) with a cosine ramp mask driven by the training step
    progressive_band_time: bool = False
    freq_masking_steps: int = 5000

    @property
    def t_multires(self) -> int:
        return 6 if self.is_blender else 10

    @property
    def skip(self) -> int:
        return self.depth // 2


def embed_dim(multires: int, in_dim: int) -> int:
    return in_dim * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., d] -> [..., d*(1+2*multires)]: (x, sin(2^k x), cos(2^k x))_k."""
    if multires == 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]             # [..., F, d]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # [..., F, 2d]
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def progressive_band_encoding(x: torch.Tensor, multires: int, step,
                              masking_steps: int) -> torch.Tensor:
    """sin/cos bands only, each frequency gated by a cosine ramp of the
    training ``step`` (low frequencies first)."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    ramp = torch.clamp(
        torch.as_tensor(step, dtype=x.dtype, device=x.device)
        / max(masking_steps, 1) * multires
        - torch.arange(multires, dtype=x.dtype, device=x.device), 0.0, 1.0)
    mask = (1.0 - torch.cos(math.pi * ramp)) / 2.0    # [F]
    ang = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) * mask[:, None]
    return enc.reshape(*x.shape[:-1], -1)


def mlp_from_arrays(tree: dict, device) -> nn.ModuleDict:
    """Build a deform field's parameter module from a nested dict of
    arrays: the MLP's ({"layers": [{"w", "b"}, ...], "warp": {"w", "b"},
    ...}), the hash field's ({"tables": [...], "mlp": [...], ...}) or the
    static field's {}.  A dict of arrays becomes an ``nn.ParameterDict``,
    a list of arrays an ``nn.ParameterList``, and deeper dicts and lists
    ``nn.ModuleDict``/``nn.ModuleList``, so ``named_parameters`` spells
    the JAX pytree's paths ("layers.0.w", "tables.3")."""
    dev = torch.device(device)

    def leaf(v):
        return nn.Parameter(torch.tensor(np.asarray(v, np.float32),
                                         device=dev))

    def build(node):
        items = node.values() if isinstance(node, dict) else node
        nested = any(isinstance(v, (dict, list)) for v in items)
        if isinstance(node, dict):
            return (nn.ModuleDict({k: build(v) for k, v in node.items()})
                    if nested else
                    nn.ParameterDict({k: leaf(v) for k, v in node.items()}))
        return (nn.ModuleList([build(v) for v in node]) if nested
                else nn.ParameterList([leaf(v) for v in node]))

    return nn.ModuleDict({name: build(sub) for name, sub in tree.items()})


def init_mlp(cfg: MLPConfig, generator: torch.Generator | None = None,
             device="cuda") -> nn.ModuleDict:
    """Random init drawn on the CPU from ``generator`` (so a seed gives
    the same weights on every device), then moved to ``device``."""
    dev = resolve_device(device)
    uni = lambda shape, bound: (torch.rand(shape, generator=generator)
                                * 2.0 - 1.0) * bound
    x_ch = embed_dim(cfg.multires_x, 3)
    t_raw_ch = (2 * cfg.t_multires if cfg.progressive_band_time
                else embed_dim(cfg.t_multires, 1))
    t_ch = cfg.time_out if cfg.is_blender else t_raw_ch
    in_ch = x_ch + t_ch
    tree = {}
    if cfg.is_blender:
        # torch nn.Linear default init for the reference's timenet
        b0, b1 = 1.0 / np.sqrt(t_raw_ch), 1.0 / np.sqrt(256)
        tree["timenet"] = {"w0": uni((t_raw_ch, 256), b0),
                           "b0": uni((256,), b0),
                           "w1": uni((256, cfg.time_out), b1),
                           "b1": uni((cfg.time_out,), b1)}
    layers = []
    for i in range(cfg.depth):
        fan_in = in_ch if i == 0 else (
            cfg.width + in_ch if i - 1 == cfg.skip else cfg.width)
        # kaiming uniform: gain sqrt(2) * sqrt(3 / fan_in)
        layers.append({"w": uni((fan_in, cfg.width), np.sqrt(6.0 / fan_in)),
                       "b": torch.zeros((cfg.width,))})
    tree["layers"] = layers

    def head(out, std):
        return {"w": std * torch.randn((cfg.width, out), generator=generator),
                "b": torch.zeros((out,))}

    tree["warp"] = head(3, 1e-5)
    tree["scaling"] = head(2, 1e-8)
    tree["rotation"] = head(4, 1e-5)
    if cfg.local_frame:
        tree["local_rotation"] = head(4, 1e-4)
    if cfg.pred_opacity:
        tree["opacity"] = head(1, 1e-5)
    if cfg.pred_color:
        tree["color"] = head(3, 1e-5)
    return mlp_from_arrays(tree, dev)


def mlp_forward(params: nn.ModuleDict, cfg: MLPConfig, x: torch.Tensor,
                t: torch.Tensor, step=10**9) -> dict:
    """x: [..., 3] canonical positions; t: [..., 1] timestamps; step: the
    training iteration (drives progressive_band_time only).

    Returns dict with d_xyz [...,3], d_rotation [...,4], d_scaling [...,2]
    and optional d_opacity/d_color/local_rotation.
    """
    if cfg.progressive_band_time:
        t_emb = progressive_band_encoding(t, cfg.t_multires, step,
                                          cfg.freq_masking_steps)
    else:
        t_emb = positional_encoding(t, cfg.t_multires)
    if cfg.is_blender:
        tn = params["timenet"]
        h_t = torch.relu(t_emb @ tn["w0"] + tn["b0"])
        t_emb = h_t @ tn["w1"] + tn["b1"]
    x_emb = positional_encoding(x, cfg.multires_x)
    inp = torch.cat([x_emb, t_emb], dim=-1)

    h = inp
    depth = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = torch.relu(h @ layer["w"] + layer["b"])
        # the concat feeds the NEXT layer; when the skip index is the
        # final layer (tiny test depths) it has no consumer
        if i == cfg.skip and i + 1 < depth:
            h = torch.cat([inp, h], dim=-1)

    def apply(name):
        hd = params[name]
        return h @ hd["w"] + hd["b"]

    d_scaling = apply("scaling")
    if cfg.max_d_scale > 0:
        d_scaling = torch.tanh(d_scaling) * float(np.log(cfg.max_d_scale))
    out = {"d_xyz": apply("warp"), "d_rotation": apply("rotation"),
           "d_scaling": d_scaling, "hidden": h,
           "d_opacity": apply("opacity") if cfg.pred_opacity else None,
           "d_color": apply("color") if cfg.pred_color else None}
    if cfg.local_frame:
        out["local_rotation"] = apply("local_rotation")
    return out
