"""The control-node field (``deform_type`` "node", the reference's
default): the 8x256 deform MLP with the Blender timenet evaluated at the
nodes, each surfel moved by linear blend skinning of the rigid frames of
its K nearest nodes in (xyz + hyper) space."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import ROT_BIAS, positional_encoding, quat_to_rotmat
from . import dense_ops


def _in_ch(cfg: dict) -> int:
    return 3 * (1 + 2 * cfg["multires_x"]) + cfg["time_out"]


def shapes(cfg: dict) -> list:
    t_raw = 1 + 2 * cfg["t_multires"]
    in_ch = _in_ch(cfg)
    W, depth = cfg["deform_width"], cfg["deform_depth"]
    b0, b1 = 1 / math.sqrt(t_raw), 1 / math.sqrt(256)
    out = [("timenet.w0", (t_raw, 256), "u", b0),
           ("timenet.b0", (256,), "u", b0),
           ("timenet.w1", (256, cfg["time_out"]), "u", b1),
           ("timenet.b1", (cfg["time_out"],), "u", b1)]
    for i in range(depth):
        fan = in_ch if i == 0 else (W + in_ch if i - 1 == depth // 2 else W)
        out += [(f"layers.{i}.w", (fan, W), "u", math.sqrt(6 / fan)),
                (f"layers.{i}.b", (W,), "0", 0.0)]
    for name, dout in (("warp", 3), ("scaling", 2), ("rotation", 4),
                       ("local_rotation", 4)):
        out += [(f"{name}.w", (W, dout), "n", cfg["head_std"][name]),
                (f"{name}.b", (dout,), "0", 0.0)]
    return out


def fps(points: torch.Tensor, n: int, start: int) -> torch.Tensor:
    """Farthest-point sample of ``n`` rows from ``start``."""
    idx = torch.empty((n,), dtype=torch.int64, device=points.device)
    idx[0] = start
    dist = torch.full((points.shape[0],), float("inf"), device=points.device)
    for i in range(1, n):
        dist = torch.minimum(dist, torch.sum(
            (points - points[idx[i - 1]]) ** 2, dim=-1))
        idx[i] = torch.argmax(dist)
    return idx


def extra_state(cfg: dict, gauss: dict, n: int, seeds: dict, device):
    """The control nodes: ``node_num`` farthest-point samples of the
    ``n`` live surfels from a seeded start, hyper coordinates 1e-2, the
    radius log(0.1 scene range)."""
    pts = gauss["xyz"][:n]
    m = cfg["node_num"]
    start = int(np.random.RandomState(seeds["fps"] % (1 << 31)).randint(n))
    idx = fps(pts, m, start)
    rng = torch.max(pts) - torch.min(pts)
    return dict(
        nodes=torch.cat([pts[idx], 1e-2 * torch.ones(
            (m, cfg["hyper_dim"]), device=device)], -1),
        node_radius=torch.log(0.1 * rng + 1e-7) * torch.ones(
            (m,), device=device),
        node_weight=torch.zeros((m, 1), device=device),
        alive=torch.ones((m,), dtype=torch.bool, device=device))


def deform_mlp(p: dict, cfg: dict, x, t):
    """The 8x256 deform MLP (DeformNetwork) with the Blender timenet and
    local-frame head; ``p`` by the names "timenet.w0", "layers.3.b",
    "warp.w", ...  Returns (d_xyz, d_rotation, d_scaling, local_rot)."""
    t_emb = positional_encoding(t, cfg["t_multires"])
    t_emb = (torch.relu(t_emb @ p["timenet.w0"] + p["timenet.b0"])
             @ p["timenet.w1"] + p["timenet.b1"])
    inp = torch.cat([positional_encoding(x, cfg["multires_x"]), t_emb], -1)
    h, depth, skip = inp, cfg["deform_depth"], cfg["deform_depth"] // 2
    for i in range(depth):
        h = torch.relu(h @ p[f"layers.{i}.w"] + p[f"layers.{i}.b"])
        if i == skip and i + 1 < depth:
            h = torch.cat([inp, h], dim=-1)
    head = lambda n: h @ p[f"{n}.w"] + p[f"{n}.b"]
    return head("warp"), head("rotation"), head("scaling"), \
        head("local_rotation")


def node_warp(nodes: dict, field: dict, cfg: dict, x, t, feature,
              motion_mask):
    """ControlNodeWarp with local frames and linear blend skinning: the
    K nearest nodes in (xyz + hyper) space, chosen on bfloat16 distances,
    Gaussian-kernel weights, the per-node rigid frames blended."""
    K, hyper = cfg["K"], cfg["hyper_dim"]
    nd = nodes["nodes"]
    m = nd.shape[0]
    q = torch.cat([x.detach(), feature[..., :hyper]], dim=-1)
    ref = torch.cat([nd[:, :3].detach(), nd[:, 3:]], dim=-1)
    with torch.no_grad():
        q_sg, ref_sg = q.detach(), ref.detach()
        d2 = (torch.sum(q_sg * q_sg, dim=-1, keepdim=True)
              + torch.sum(ref_sg * ref_sg, dim=-1)[None, :]
              - 2.0 * (q_sg @ ref_sg.T))
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(nodes["alive"][None, :], d2, float("inf"))
        d2 = d2.to(torch.bfloat16)
        rows = torch.arange(d2.shape[0], device=d2.device)
        idxs = []
        for _ in range(K):
            i = torch.argmin(d2, dim=1)
            idxs.append(i)
            d2[rows, i] = float("inf")
        idx = torch.stack(idxs, dim=-1)
    dd = ref.shape[-1]
    pack = torch.cat([ref, torch.exp(nodes["node_radius"])[:, None],
                      nodes["node_weight"]], dim=-1)
    pk = pack[idx]
    diff = q[:, None, :] - pk[..., :dd]
    dist = torch.sum(diff * diff, dim=-1)
    r = pk[..., dd]
    w = torch.exp(-dist / (2.0 * r * r)) * torch.sigmoid(pk[..., dd + 1])
    w = w + 1e-7
    w = w / torch.sum(w, dim=-1, keepdim=True)

    tt = torch.as_tensor(t, dtype=torch.float32,
                         device=nd.device).reshape(1, 1).expand(m, 1)
    trans, rot, scale, local = deform_mlp(field, cfg, nd[:, :3].detach(), tt)
    bias = torch.tensor(ROT_BIAS, device=x.device)
    Rl = quat_to_rotmat(local + bias)
    p = nd[:, :3].detach()
    v = p + trans - torch.einsum("mij,mj->mi", Rl, p)
    cols = [Rl.reshape(m, 9), v, rot, scale]
    table = torch.cat(cols, dim=-1)
    blended = torch.sum(w[..., None] * table[idx], dim=1)
    Rb, vb, rot_b, scale_b = torch.split(blended, [9, 3, 4, 2], dim=-1)
    xd = x.detach()
    translate = torch.einsum("nij,nj->ni", Rb.reshape(-1, 3, 3), xd) \
        + vb - xd
    return translate * motion_mask, rot_b * motion_mask, \
        scale_b * motion_mask


def forward(state: dict, cfg: dict, t, step):
    g = state["gauss"]
    mm = torch.sigmoid(g["feature"][..., -1:])
    return node_warp(state["nodes"], state["field"], cfg, g["xyz"], t,
                     g["feature"], mm)


def fwd_ops(cfg: dict, n_live: int) -> tuple[float, float]:
    """The MLP and timenet at the nodes and the K=3 LBS blend
    (differentiated); the K-nearest-node choice over every node (not)."""
    m, W = cfg["node_num"], cfg["deform_width"]
    t_raw = 1 + 2 * cfg["t_multires"]
    in_ch = _in_ch(cfg)
    depth = cfg["deform_depth"]
    dims = [(t_raw, 256), (256, cfg["time_out"]), (in_ch, W)]
    for i in range(1, depth):
        dims.append((W + in_ch if i - 1 == depth // 2 else W, W))
    dims.append((W, 3 + 4 + 2 + 4))
    mlp = dense_ops(m, dims)
    # the K-nearest-node distances in (xyz + hyper) space, the kernel
    # weights and the blend of the 18-wide per-node frames
    d = 3 + cfg["hyper_dim"]
    knn = 2.0 * n_live * m * d + 3.0 * n_live * m
    lbs = n_live * cfg["K"] * (2 * d + 8 + 2 * 18) + n_live * 30
    return mlp + lbs, knn
