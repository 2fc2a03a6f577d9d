"""Hash-grid deformation field (counterpart of d2dgs_tpu/models/hash_deform.py,
the reference's HashDeformNetwork with its progressive band hash encoding,
utils/time_utils.py:517-767).

A multi-resolution hash grid (12 levels, 2 features a level, 2^19
entries, base resolution 16, scale 2.0) under a cosine-ramp mask that
opens the fine levels with the training step, then an MLP and small
per-quantity heads.  The encoding is plain PyTorch: a gather per level
and trilinear (quadrilinear with ``hash_time``) interpolation.

The parameters are an ``nn.ModuleDict`` whose names spell the JAX pytree
("tables.0", "mlp.2.w", "translate.w0"), so weights and checkpoints
carry across unchanged.  As in the JAX package, the scaling head emits 2
channels (surfel scales) and ``d_rotation`` is a pure residual.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .. import trace
from ..utils.general import resolve_device
from .deform_mlp import embed_dim, mlp_from_arrays, positional_encoding

# spatial hash primes (tcnn convention; first coordinate unhashed)
_PRIMES = (1, 2654435761, 805459861, 3674653429)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashConfig:
    n_levels: int = 12
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    start_level: int = 6
    start_step: int = 1000
    update_steps: int = 1000
    hash_time: bool = False          # 4-D (x,t) grid vs 3-D grid + PE(t)
    num_layers: int = 2
    hidden: int = 256
    head_width: int = 64
    t_multires: int = 6
    bbox: tuple = (-2.0, 2.0)
    scale_range: float = 2.0
    local_frame: bool = False
    pred_opacity: bool = False
    pred_color: bool = False

    @property
    def in_dim(self) -> int:
        return 4 if self.hash_time else 3

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def enc_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def n_masking_step(self) -> int:
        return (self.n_levels - self.start_level) * self.update_steps

    def resolution(self, level: int) -> int:
        return int(np.floor(self.base_resolution
                            * self.per_level_scale ** level))


def _corner_index(coords: torch.Tensor, res: int, table_size: int,
                  d: int) -> torch.Tensor:
    """Integer grid coords [..., d] -> table index [...] (int64).

    Dense row-major strides when the level's grid fits the table, else
    the spatial hash: the XOR of prime-multiplied coords, each product
    wrapped to 32 bits as the JAX package's uint32 arithmetic wraps it
    (coords are at most 2^15 and the primes below 2^32, so each product
    fits in int64 before the mask)."""
    coords = coords.to(torch.int64)
    if (res + 1) ** d <= table_size:
        idx = coords[..., 0]
        for k in range(1, d):
            idx = idx * (res + 1) + coords[..., k]
        return idx
    h = (coords[..., 0] * _PRIMES[0]) & _MASK32
    for k in range(1, d):
        h = h ^ ((coords[..., k] * _PRIMES[k]) & _MASK32)
    return h & (table_size - 1)


def band_mask(cfg: HashConfig, step, device) -> torch.Tensor:
    """[enc_dim] cosine band mask of ProgressiveBandHashGridCosine
    (time_utils.py:560-570): levels below ``start_level`` always on, the
    rest opened feature by feature over ``n_masking_step`` steps."""
    j = torch.arange(cfg.enc_dim, dtype=torch.float32, device=device)
    start_idx = cfg.start_level * cfg.n_features
    band_len = cfg.enc_dim - start_idx
    trace.count("host.reads", 1)  # a copy from host memory
    ratio = (torch.as_tensor(step, dtype=torch.float32, device=device)
             / max(cfg.n_masking_step, 1))
    ramp = torch.clamp(ratio * band_len - (j - start_idx), 0.0, 1.0)
    return torch.where(j < start_idx, 1.0,
                       (1.0 - torch.cos(math.pi * ramp)) / 2.0)


def hash_encode(tables, cfg: HashConfig, x01: torch.Tensor,
                step) -> torch.Tensor:
    """x01: [N, d] in [0,1] -> [N, n_levels * n_features], masked by
    ``band_mask`` at ``step``.  As in the JAX package, ``frac`` is taken
    before the cell index is clipped to ``res - 1``: at x01 == 1 the
    weight falls on corner ``res - 1``."""
    d = cfg.in_dim
    n = x01.shape[0]
    trace.count("host.reads", 1)  # a copy from host memory
    corners = torch.tensor(
        np.stack(np.meshgrid(*([[0, 1]] * d), indexing="ij"),
                 axis=-1).reshape(-1, d), device=x01.device)   # [2^d, d]
    cf = corners.to(x01.dtype)
    outs = []
    for lvl in range(cfg.n_levels):
        res = cfg.resolution(lvl)
        pos = x01 * res
        lo = torch.floor(pos)
        frac = pos - lo
        lo = torch.clamp(lo.to(torch.int64), 0, res - 1)
        cidx = lo[:, None, :] + corners[None]                  # [N, 2^d, d]
        tidx = _corner_index(cidx, res, cfg.table_size, d)     # [N, 2^d]
        # index_select's backward is an index_add_ (atomic adds on the
        # card); advanced indexing's sorts the indices and walks each
        # repeated one serially, and the dead capacity rows all repeat
        # the corners of one point (chip_smoke.py phase 9 times both)
        vals = torch.index_select(tables[lvl], 0, tidx.reshape(-1)) \
            .reshape(*tidx.shape, -1)                          # [N, 2^d, F]
        w = torch.ones((n, corners.shape[0]), dtype=x01.dtype,
                       device=x01.device)
        for k in range(d):
            ck = cf[:, k][None]
            w = w * (ck * frac[:, k:k + 1]
                     + (1.0 - ck) * (1.0 - frac[:, k:k + 1]))
        outs.append(torch.sum(w[..., None] * vals, dim=1))     # [N, F]
    enc = torch.cat(outs, dim=-1)
    return enc * band_mask(cfg, step, x01.device)[None, :]


def _depth_and_skip(cfg: HashConfig):
    if cfg.hash_time:
        return cfg.num_layers, set()
    return cfg.num_layers + 2, {2}


def init_hash_deform(cfg: HashConfig,
                     generator: torch.Generator | None = None,
                     device="cuda") -> nn.ModuleDict:
    """Random init drawn on the CPU from ``generator``, then moved to
    ``device``: tables uniform in +-1e-4, Kaiming-uniform layers, the
    main MLP's output layer near zero (std 1e-5; sqrt(2/W) with
    ``hash_time``) and the heads."""
    dev = resolve_device(device)

    def uni(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    def kaiming(fan_in, fan_out):
        return uni((fan_in, fan_out), np.sqrt(6.0 / fan_in))

    def head(din, width, dout):
        return {"w0": kaiming(din, width), "b0": torch.zeros((width,)),
                "w1": kaiming(width, dout), "b1": torch.zeros((dout,))}

    tree = {"tables": [uni((cfg.table_size, cfg.n_features), 1e-4)
                       for _ in range(cfg.n_levels)]}
    t_dim = 0 if cfg.hash_time else embed_dim(cfg.t_multires, 1)
    din = cfg.enc_dim + t_dim
    depth, skip = _depth_and_skip(cfg)
    W = cfg.hidden
    layers, prev = [], din
    for i in range(depth):
        fan_in = prev + (din if i in skip else 0)
        layers.append({"w": kaiming(fan_in, W), "b": torch.zeros((W,))})
        prev = W
    std = np.sqrt(2.0 / W) if cfg.hash_time else 1e-5
    layers.append({"w": torch.randn((W, W), generator=generator) * std,
                   "b": torch.zeros((W,))})
    tree["mlp"] = layers
    heads = [("translate", 3), ("rotation", 4), ("scaling", 2)]
    if cfg.local_frame:
        heads.append(("local_rotation", 4))
    if cfg.pred_opacity:
        heads.append(("opacity", 1))
    if cfg.pred_color:
        heads.append(("color", 3))
    for name, dout in heads:
        tree[name] = head(W, cfg.head_width, dout)
    return mlp_from_arrays(tree, dev)


def _head(p, h):
    return torch.relu(h @ p["w0"] + p["b0"]) @ p["w1"] + p["b1"]


def hash_deform_forward(params: nn.ModuleDict, cfg: HashConfig,
                        x: torch.Tensor, t, step=10**9) -> dict:
    """x: [N,3] world positions; t: scalar or [N,1]; step: the training
    step driving the band mask (default: fully open)."""
    n = x.shape[0]
    lo, hi = cfg.bbox
    x01 = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    tt = t.reshape(1, 1).expand(n, 1) if t.dim() == 0 else t

    if cfg.hash_time:
        h = hash_encode(params["tables"], cfg, torch.cat([x01, tt], dim=-1),
                        step)
    else:
        enc = hash_encode(params["tables"], cfg, x01, step)
        t_emb = positional_encoding(tt, cfg.t_multires)
        # align scales (time_utils.py:748), in this order
        t_emb = t_emb / t_emb.shape[-1] * cfg.enc_dim
        h = torch.cat([enc, t_emb], dim=-1)

    x_in = h
    depth, skip = _depth_and_skip(cfg)
    mlp = params["mlp"]
    for i in range(depth):
        if i in skip:
            h = torch.cat([h, x_in], dim=-1)
        h = torch.relu(h @ mlp[i]["w"] + mlp[i]["b"])
    h = h @ mlp[depth]["w"] + mlp[depth]["b"]

    out = {
        "d_xyz": _head(params["translate"], h),
        "d_rotation": _head(params["rotation"], h),
        "d_scaling": torch.tanh(_head(params["scaling"], h))
        * float(np.log(cfg.scale_range)),
        "d_opacity": (_head(params["opacity"], h)
                      if cfg.pred_opacity else None),
        "d_color": _head(params["color"], h) if cfg.pred_color else None,
    }
    if cfg.local_frame:
        out["local_rotation"] = _head(params["local_rotation"], h)
    return out
