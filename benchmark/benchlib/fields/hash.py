"""The hash-grid field (``deform_type`` "hash", the reference's
``HashDeformNetwork``): a 3-D multi-resolution hash grid under the
cosine band mask, PE(t), the MLP and three heads, per surfel."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import positional_encoding
from . import dense_ops

_PRIMES = (1, 2654435761, 805459861, 3674653429)


def _dims(cfg: dict) -> list:
    """(fan_in, fan_out) of the MLP's layers and the heads'."""
    din = cfg["n_levels"] * cfg["n_features"] + 1 + 2 * cfg["t_multires"]
    W, depth = cfg["hidden"], cfg["num_layers"] + 2
    dims, prev = [], din
    for i in range(depth):
        dims.append((prev + (din if i == 2 else 0), W))
        prev = W
    dims.append((W, W))
    hw = cfg["head_width"]
    for dout in (3, 4, 2):
        dims += [(W, hw), (hw, dout)]
    return dims


def shapes(cfg: dict) -> list:
    size = 1 << cfg["log2_hashmap_size"]
    out = [(f"tables.{lvl}", (size, cfg["n_features"]), "u",
            cfg["table_init"]) for lvl in range(cfg["n_levels"])]
    dims, depth = _dims(cfg), cfg["num_layers"] + 2
    for i in range(depth):
        fan, W = dims[i]
        out += [(f"mlp.{i}.w", (fan, W), "u", math.sqrt(6 / fan)),
                (f"mlp.{i}.b", (W,), "0", 0.0)]
    W = cfg["hidden"]
    out += [(f"mlp.{depth}.w", (W, W), "n", cfg["mlp_out_std"]),
            (f"mlp.{depth}.b", (W,), "0", 0.0)]
    hw = cfg["head_width"]
    for name, dout in (("translate", 3), ("rotation", 4), ("scaling", 2)):
        out += [(f"{name}.w0", (W, hw), "u", math.sqrt(6 / W)),
                (f"{name}.b0", (hw,), "0", 0.0),
                (f"{name}.w1", (hw, dout), "u",
                 math.sqrt(6 / hw) * cfg["head_out_scale"]),
                (f"{name}.b1", (dout,), "0", 0.0)]
    return out


def extra_state(cfg: dict, gauss: dict, n: int, seeds: dict, device):
    return None


def hash_field(field: dict, cfg: dict, x, t, step):
    """HashDeformNetwork: 3-D multi-resolution hash grid under the
    cosine band mask, PE(t), the MLP and the three heads."""
    n = x.shape[0]
    lo, hi = cfg["bbox"]
    x01 = torch.clamp((x.detach() - lo) / (hi - lo), 0.0, 1.0)
    levels, feats = cfg["n_levels"], cfg["n_features"]
    size = 1 << cfg["log2_hashmap_size"]
    corners = torch.tensor(np.stack(np.meshgrid(*([[0, 1]] * 3),
                                                indexing="ij"), -1)
                           .reshape(-1, 3), device=x.device)
    cf = corners.to(x01.dtype)
    outs = []
    for lvl in range(levels):
        res = int(np.floor(cfg["base_resolution"]
                           * cfg["per_level_scale"] ** lvl))
        pos = x01 * res
        lo_i = torch.floor(pos)
        frac = pos - lo_i
        lo_i = torch.clamp(lo_i.to(torch.int64), 0, res - 1)
        c = lo_i[:, None, :] + corners[None]
        if (res + 1) ** 3 <= size:
            tidx = (c[..., 0] * (res + 1) + c[..., 1]) * (res + 1) + c[..., 2]
        else:
            h = (c[..., 0] * _PRIMES[0]) & 0xFFFFFFFF
            for k in (1, 2):
                h = h ^ ((c[..., k] * _PRIMES[k]) & 0xFFFFFFFF)
            tidx = h & (size - 1)
        vals = torch.index_select(field[f"tables.{lvl}"], 0,
                                  tidx.reshape(-1)).reshape(*tidx.shape, -1)
        w = torch.ones((n, 8), dtype=x01.dtype, device=x.device)
        for k in range(3):
            ck = cf[:, k][None]
            f = frac[:, k:k + 1]
            w = w * (ck * f + (1.0 - ck) * (1.0 - f))
        outs.append(torch.sum(w[..., None] * vals, dim=1))
    enc = torch.cat(outs, dim=-1)
    j = torch.arange(levels * feats, dtype=torch.float32, device=x.device)
    start = cfg["start_level"] * feats
    ratio = (torch.as_tensor(step, dtype=torch.float32, device=x.device)
             / max((levels - cfg["start_level"]) * cfg["update_steps"], 1))
    ramp = torch.clamp(ratio * (levels * feats - start) - (j - start), 0.0,
                       1.0)
    mask = torch.where(j < start, 1.0, (1.0 - torch.cos(math.pi * ramp)) / 2.0)
    enc = enc * mask[None, :]
    tt = torch.as_tensor(t, dtype=torch.float32,
                         device=x.device).reshape(1, 1).expand(n, 1)
    t_emb = positional_encoding(tt, cfg["t_multires"])
    t_emb = t_emb / t_emb.shape[-1] * (levels * feats)
    h = torch.cat([enc, t_emb], dim=-1)
    x_in, depth = h, cfg["num_layers"] + 2
    for i in range(depth):
        if i == 2:
            h = torch.cat([h, x_in], dim=-1)
        h = torch.relu(h @ field[f"mlp.{i}.w"] + field[f"mlp.{i}.b"])
    h = h @ field[f"mlp.{depth}.w"] + field[f"mlp.{depth}.b"]
    head = lambda nm: (torch.relu(h @ field[f"{nm}.w0"] + field[f"{nm}.b0"])
                       @ field[f"{nm}.w1"] + field[f"{nm}.b1"])
    return head("translate"), head("rotation"), \
        torch.tanh(head("scaling")) * float(np.log(cfg["scale_range"]))


def forward(state: dict, cfg: dict, t, step):
    return hash_field(state["field"], cfg, state["gauss"]["xyz"], t, step)


def fwd_ops(cfg: dict, n_live: int) -> tuple[float, float]:
    """Per level 8 corners' trilinear weights (3 products each) and the
    weighted sum of their features; the MLP and heads per surfel."""
    lv, f = cfg["n_levels"], cfg["n_features"]
    enc = n_live * lv * 8 * (3 + 2 * f)
    return enc + dense_ops(n_live, _dims(cfg)), 0.0
