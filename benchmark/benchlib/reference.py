"""Plain float32 reference of one D-2DGS view and one main-stage training
step, in PyTorch, independent of the port.

It follows the reference system's equations (2DGS surfel splatting with
the control-node or hash-grid deformation field, the D-NeRF losses and
Adam) in the order the port's plain versions compute them, so that on
one device the two differ only where the port's kernels walk the blend
in another order.  It imports nothing of ``d2dgs_torch``: it is a frozen
copy of the port's plain versions (``ops/blend.py``, ``ops/binning.py``,
``ops/projection.py``, ``ops/ssim.py``, ``train/optim.py``; the
deformation fields' in ``fields/``, one module each), cut to the paths
the benchmark's configurations take.

The blend is the sequential front-to-back walk (64 pairs a step, every
tile at once); its gradient is autograd through the same walk, rerun
in blocks of tiles of similar pair counts so that it fits
(``PlainBlend``).

``precision(tf32=True)`` runs everything in TF32 where PyTorch offers it
(matrix products and convolutions): the control that the comparison has
to refuse.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
FILTER_SIZE = 0.7071067811865476
FILTER_INV_SQUARE = 1.0 / (FILTER_SIZE * FILTER_SIZE)
ALPHA_CLIP = 0.99
ALPHA_CUTOFF = 1.0 / 255.0
T_CUTOFF = 1e-4
TRUNCATED_R = 3.0
NEAR_PLANE = 0.2
FAR_PLANE = 100.0
ROT_BIAS = (1.0, 0.0, 0.0, 0.0)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# the state rows a walk returns per pixel
ROW_T, ROW_COLOR, ROW_DEPTH, ROW_NORMAL = 0, slice(1, 4), 4, slice(5, 8)
ROW_DIST, ROW_MED_D, ROW_MED_W, ROW_N_EVAL, ROW_N_BLEND = 8, 9, 10, 11, 12
CHUNK = 64
# (tiles x CHUNK-pair steps) per block of the blend's gradient
BWD_TILE_CHUNKS = 4096

_TF32 = {"on": False}


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (``tf32``) or float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, _TF32["on"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32["on"] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32["on"]) = prev


# ----------------------------------------------------------------------
# quaternions, SH
# ----------------------------------------------------------------------

def quat_normalize(q, eps=0.0):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q):
    q = quat_normalize(q, eps=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (x * z + w * y)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def sh_to_rgb(deg: int, sh, dirs):
    """Degrees 0-3 of the real SH basis (computeColorFromSH), clamped."""
    if deg > 3:
        raise ValueError("the reference evaluates SH up to degree 3")
    r = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        r = r + (-SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :]
                 - SH_C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            r = r + (SH_C2[0] * xy * sh[..., 4, :]
                     + SH_C2[1] * yz * sh[..., 5, :]
                     + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                     + SH_C2[3] * xz * sh[..., 7, :]
                     + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                r = r + (
                    SH_C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                    * sh[..., 12, :]
                    + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return torch.clamp_min(r + 0.5, 0.0)


# ----------------------------------------------------------------------
# deformation fields
# ----------------------------------------------------------------------

def positional_encoding(x, multires: int):
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def deform(state: dict, cfg: dict, t, step):
    """The field's (d_xyz, d_rotation, d_scaling) of every slot at time
    ``t`` (``fields/<deform_type>.py``)."""
    from .fields import field
    return field(cfg["deform_type"]).forward(state, cfg, t, step)


# ----------------------------------------------------------------------
# projection and binning
# ----------------------------------------------------------------------

def matmul_fma(A, B):
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        out = torch.addcmul(out, A[..., :, k:k + 1], B[..., k:k + 1, :])
    return out


def intrinsics(cam: dict):
    dev = cam["w2c"].device
    z = torch.zeros((), dtype=torch.float32, device=dev)
    o = torch.ones((), dtype=torch.float32, device=dev)
    cx = torch.full((), cam["W"] / 2.0, dtype=torch.float32, device=dev)
    cy = torch.full((), cam["H"] / 2.0, dtype=torch.float32, device=dev)
    return torch.stack([torch.stack([cam["fx"], z, cx]),
                        torch.stack([z, cam["fy"], cy]),
                        torch.stack([z, z, o])])


def grid(cam):
    return -(-cam["W"] // TILE), -(-cam["H"] // TILE)


def preprocess(means3d, scales, quats, cam):
    """Surfel -> screen transform T, normal, AABB and tile rect, with the
    near-plane, edge-on and degenerate culls (2DGS forward.cu)."""
    Rw, tw = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    p_view = matmul_fma(means3d[:, None, :], Rw.T)[:, 0] + tw
    in_front = p_view[:, 2] > NEAR_PLANE
    WR = matmul_fma(Rw, quat_to_rotmat(quats))
    M0 = WR[:, :, 0] * scales[:, 0:1]
    M1 = WR[:, :, 1] * scales[:, 1:2]
    tn = WR[:, :, 2]
    cosang = -torch.sum(tn * p_view, dim=-1)
    tn = torch.where(cosang[:, None] > 0, tn, -tn)
    T = matmul_fma(intrinsics(cam), torch.stack([M0, M1, p_view], dim=-1))
    Tu, Tv, Tw = T[:, 0, :], T[:, 1, :], T[:, 2, :]
    f_sign = torch.tensor([1.0, 1.0, -1.0], dtype=T.dtype, device=T.device)
    d = torch.sum(f_sign * Tw * Tw, dim=-1)
    nondeg = d != 0.0
    f = f_sign / torch.where(nondeg, d, torch.ones_like(d))[:, None]
    cx = torch.sum(f * Tu * Tw, dim=-1)
    cy = torch.sum(f * Tv * Tw, dim=-1)
    ex = torch.sqrt(torch.clamp_min(cx * cx - torch.sum(f * Tu * Tu, -1), 0.0))
    ey = torch.sqrt(torch.clamp_min(cy * cy - torch.sum(f * Tv * Tv, -1), 0.0))
    radius_f = torch.ceil(TRUNCATED_R * torch.clamp_min(torch.maximum(ex, ey),
                                                        FILTER_SIZE))
    gx, gy = grid(cam)
    i32 = lambda v, hi: torch.clamp(
        torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, hi + 1.0)
        .to(torch.int32), 0, hi)
    rmin = torch.stack([i32((cx - radius_f) / TILE, gx),
                        i32((cy - radius_f) / TILE, gy)], -1)
    rmax = torch.stack([i32((cx + radius_f + TILE - 1) / TILE, gx),
                        i32((cy + radius_f + TILE - 1) / TILE, gy)], -1)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    valid = in_front & (cosang != 0.0) & nondeg & (area > 0)
    return dict(T=T, normal=tn, depth=p_view[:, 2],
                center=torch.stack([cx, cy], -1), valid=valid,
                radius=torch.where(valid, radius_f, 0.0).to(torch.int32),
                rect_min=rmin, rect_max=rmax)


def visibility_circle(prep, opacity):
    """The smallest circle holding every pixel where the surfel's alpha
    can reach 1/255, as (centre, signed r^2): 1e30 where the level set
    is unbounded, -1 where the opacity is below 1/255."""
    op = opacity.detach().to(torch.float32)
    L = torch.clamp_min(torch.log(torch.clamp_min(255.0 * op, 1e-12)), 0.0)
    rho = 2.0 * L
    T = prep["T"].detach().to(torch.float32)
    Tu, Tv, Tw = T[:, 0, :], T[:, 1, :], T[:, 2, :]
    d = rho * (Tw[:, 0] ** 2 + Tw[:, 1] ** 2) - Tw[:, 2] ** 2
    good = d != 0.0
    inv_d = torch.where(good, 1.0 / torch.where(good, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    frho, fz = rho * inv_d, -inv_d
    dot2 = lambda A, B: frho * (A[:, 0] * B[:, 0] + A[:, 1] * B[:, 1]) \
        + fz * A[:, 2] * B[:, 2]
    cx, cy = dot2(Tu, Tw), dot2(Tv, Tw)
    vxx, vyy = cx * cx - dot2(Tu, Tu), cy * cy - dot2(Tv, Tv)
    vxy = cx * cy - dot2(Tu, Tv)
    mid, dif = 0.5 * (vxx + vyy), 0.5 * (vxx - vyy)
    lam = mid + torch.sqrt(torch.clamp_min(dif * dif + vxy * vxy, 0.0))
    r_lv = torch.sqrt(torch.clamp_min(lam, 0.0)) + 1e-2
    cullable = good & (vxx >= 0.0) & (vyy >= 0.0)
    c_lp = prep["center"].detach().to(torch.float32)
    r_lp = torch.sqrt(L) + 1e-2
    delta = torch.stack([cx, cy], dim=-1) - c_lp
    dd = torch.sqrt(delta[:, 0] ** 2 + delta[:, 1] ** 2)
    s = torch.clamp((dd + r_lv - r_lp) / torch.clamp_min(2.0 * dd, 1e-12),
                    0.0, 1.0)
    center = c_lp + s[:, None] * delta
    radius = torch.maximum(s * dd + r_lp, (1.0 - s) * dd + r_lv)
    sr2 = torch.where(op < 1.0 / 255.0, torch.full_like(radius, -1.0),
                      torch.where(cullable, radius * radius,
                                  torch.full_like(radius, 1e30)))
    return center, sr2


def bin_pairs(prep, opacity, cam):
    """Per-tile depth-ordered pair lists: (order, pair_rank, tile_start,
    tile_count), every valid surfel's tile rect less the tiles its
    visibility circle misses."""
    gx, gy = grid(cam)
    n = prep["depth"].shape[0]
    dev = prep["depth"].device
    key = torch.where(prep["valid"], prep["depth"],
                      torch.full_like(prep["depth"], float("inf")))
    order = torch.sort(key, stable=True).indices
    ccen, sr2 = visibility_circle(prep, opacity)
    rmin, rmax = prep["rect_min"][order], prep["rect_max"][order]
    rw, rh = rmax[:, 0] - rmin[:, 0], rmax[:, 1] - rmin[:, 1]
    area = torch.where(prep["valid"][order], rw * rh,
                       torch.zeros_like(rw)).to(torch.int64)
    offs = torch.cumsum(area, 0) - area
    g = torch.repeat_interleave(torch.arange(n, device=dev), area)
    slot = torch.arange(g.shape[0], device=dev) - offs[g]
    sw = torch.clamp_min(rw, 1).to(torch.int64)[g]
    tx = rmin[g, 0].to(torch.int64) + slot % sw
    ty = rmin[g, 1].to(torch.int64) + slot // sw
    c = ccen[order][g]
    x0 = tx.to(torch.float32) * TILE + 0.5
    y0 = ty.to(torch.float32) * TILE + 0.5
    dx = c[:, 0] - torch.minimum(torch.maximum(c[:, 0], x0), x0 + (TILE - 1.0))
    dy = c[:, 1] - torch.minimum(torch.maximum(c[:, 1], y0), y0 + (TILE - 1.0))
    keep = dx * dx + dy * dy <= sr2[order][g]
    bits = max((n - 1).bit_length(), 1)
    skey = torch.sort((((ty * gx + tx) << bits) + g)[keep]).values
    tile = skey >> bits
    edges = torch.searchsorted(tile, torch.arange(gx * gy + 1, device=dev),
                               side="left")
    return (order, (skey & ((1 << bits) - 1)), edges[:-1],
            edges[1:] - edges[:-1])


# ----------------------------------------------------------------------
# the blend: the sequential walk
# ----------------------------------------------------------------------

def tile_pixels(gx: int, tiles):
    bx, by = (tiles % gx) * TILE, (tiles // gx) * TILE
    o = torch.arange(PIX, device=tiles.device)
    return torch.stack([bx[:, None] + (o % TILE)[None] + 0.5,
                        by[:, None] + (o // TILE)[None] + 0.5],
                       -1).to(torch.float32)


def responses(T, center, opacity, pix):
    """Ray-splat intersection of G pairs x P pixels: alpha (masked by the
    near plane, p.z == 0 and the 1/255 cutoff) and depth."""
    col = lambda i, j: T[..., :, i, j, None]
    px, py = pix[..., None, :, 0], pix[..., None, :, 1]
    kx, ky, kz = px * col(2, 0) - col(0, 0), px * col(2, 1) - col(0, 1), \
        px * col(2, 2) - col(0, 2)
    lx, ly, lz = py * col(2, 0) - col(1, 0), py * col(2, 1) - col(1, 1), \
        py * col(2, 2) - col(1, 2)
    p_x, p_y, p_z = ky * lz - kz * ly, kz * lx - kx * lz, kx * ly - ky * lx
    good = p_z != 0.0
    inv = torch.where(good, 1.0 / torch.where(good, p_z, 1.0), 0.0)
    sx, sy = p_x * inv, p_y * inv
    rho3d = sx * sx + sy * sy
    dx = center[..., :, 0, None] - px
    dy = center[..., :, 1, None] - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(rho3d <= rho2d,
                        sx * col(2, 0) + sy * col(2, 1) + col(2, 2), col(2, 2))
    alpha = torch.clamp_max(opacity[..., :, None] * torch.exp(-0.5 * rho),
                            ALPHA_CLIP)
    keep = good & (depth >= NEAR_PLANE) & (alpha >= ALPHA_CUTOFF)
    return torch.where(keep, alpha, 0.0), depth


def _ex_cumsum(x):
    return torch.cat([torch.zeros_like(x[..., :1, :]),
                      torch.cumsum(x, dim=-2)[..., :-1, :]], dim=-2)


def walk(feats_sorted, pair_rank, tile_start, tile_count, gx: int, tiles):
    """Blend the pair lists of ``tiles`` front to back, CHUNK pairs a
    step: the state rows [T, 13, PIX] (ROW_*) and, per pixel, the position of
    its last blended pair (-1 for none)."""
    nt = tiles.shape[0]
    dev = feats_sorted.device
    pix = tile_pixels(gx, tiles)
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    z = lambda: torch.zeros((nt, PIX), device=dev)
    Tr, done = torch.ones((nt, PIX), device=dev), \
        torch.zeros((nt, PIX), dtype=torch.bool, device=dev)
    color, normal = torch.zeros((nt, PIX, 3), device=dev), \
        torch.zeros((nt, PIX, 3), device=dev)
    depth_acc, d1, d2, dist, med_d, med_w, n_eval, n_blend = \
        z(), z(), z(), z(), z(), z(), z(), z()
    last_pos = torch.full((nt, PIX), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    idx = lane[:, None]
    n_pairs = pair_rank.shape[0]
    for c0 in range(0, int(count.max()) if nt else 0, CHUNK):
        offs = torch.clamp(start[:, None] + c0 + lane[None], 0,
                           max(n_pairs - 1, 0))
        g = feats_sorted[pair_rank[offs].long()]
        in_range = lane[None] < (count - c0)[:, None]
        opac = torch.where(in_range, g[..., 17], 0.0)
        alpha, depth = responses(g[..., 0:9].reshape(nt, CHUNK, 3, 3),
                                 g[..., 9:11], opac, pix)
        col, nrm = g[..., 14:17], g[..., 11:14]
        one_minus = 1.0 - alpha
        cp = torch.cumprod(one_minus, dim=-2)
        T_before = Tr[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=-2)
        T_after = T_before * one_minus
        trig = (alpha > 0.0) & (T_after < T_CUTOFF)
        any_trig = torch.any(trig, dim=-2)
        first = torch.amin(torch.where(trig, idx, CHUNK), dim=-2)
        include = (idx < first[:, None, :]) & ~done[:, None, :]
        w = torch.where(include, alpha * T_before, 0.0)
        color = color + torch.einsum("tgp,tgc->tpc", w, col)
        normal = normal + torch.einsum("tgp,tgc->tpc", w, nrm)
        depth_acc = depth_acc + torch.sum(w * depth, dim=-2)
        safe = torch.where(depth != 0.0, depth, 1.0)
        m = (FAR_PLANE * depth - FAR_PLANE * NEAR_PLANE) / (
            (FAR_PLANE - NEAR_PLANE) * safe)
        wm = w * m
        wmm = wm * m
        err = m * m * (1.0 - T_before) + (d2[:, None] + _ex_cumsum(wmm)) \
            - 2.0 * m * (d1[:, None] + _ex_cumsum(wm))
        dist = dist + torch.sum(err * w, dim=-2)
        med = include & (alpha > 0.0) & (T_before > 0.5)
        has_med = torch.any(med, dim=-2)
        lm = torch.clamp_min(torch.amax(torch.where(med, idx, -1), dim=-2),
                             0)[:, None, :]
        med_d = torch.where(has_med, torch.gather(depth, -2, lm)[:, 0], med_d)
        med_w = torch.where(has_med, torch.gather(w, -2, lm)[:, 0], med_w)
        rows = torch.clamp(count - c0, 0, CHUNK)[:, None]
        evaluated = torch.where(any_trig, first + 1, rows)
        blended = include & (alpha > 0.0)
        lb = torch.amax(torch.where(blended, idx, -1), dim=-2)
        last_pos = torch.where(lb >= 0, c0 + lb, last_pos)
        n_eval = n_eval + torch.where(done, 0.0, evaluated.to(torch.float32))
        n_blend = n_blend + torch.sum(blended, dim=-2, dtype=torch.float32)
        Tr = Tr * torch.prod(torch.where(include, one_minus, 1.0), dim=-2)
        done = done | any_trig
        d1 = d1 + torch.sum(wm, dim=-2)
        d2 = d2 + torch.sum(wmm, dim=-2)
    rows = [Tr, *color.unbind(-1), depth_acc, *normal.unbind(-1), dist,
            med_d, med_w, n_eval, n_blend]
    return torch.stack(rows, dim=1), last_pos


class PlainBlend(torch.autograd.Function):
    """State rows of the walk over every tile, differentiable in the
    sorted features: the forward walks all tiles at once without a
    graph; the backward walks the tiles again under autograd, in blocks of
    similar pair counts (``tile_blocks``)."""

    @staticmethod
    def forward(ctx, feats_sorted, pair_rank, tile_start, tile_count, gx):
        tiles = torch.arange(tile_start.shape[0], device=feats_sorted.device)
        with torch.no_grad():
            state, last = walk(feats_sorted, pair_rank, tile_start,
                               tile_count, gx, tiles)
        ctx.save_for_backward(feats_sorted, pair_rank, tile_start, tile_count)
        ctx.gx = gx
        ctx.mark_non_differentiable(last)
        return state, last

    @staticmethod
    def backward(ctx, g_state, _g_last):
        feats_sorted, pair_rank, tile_start, tile_count = ctx.saved_tensors
        g_feats = torch.zeros_like(feats_sorted)
        for tiles in tile_blocks(tile_count):
            with torch.enable_grad():
                f = feats_sorted.detach().requires_grad_()
                st, _ = walk(f, pair_rank, tile_start, tile_count, ctx.gx,
                             tiles)
                g, = torch.autograd.grad(st, f, g_state[tiles])
            g_feats += g
        return g_feats, None, None, None, None


def tile_blocks(tile_count, budget: int = BWD_TILE_CHUNKS) -> list:
    """The tiles that have pairs, busiest first, in blocks whose tiles
    times the busiest one's CHUNK-pair steps stay within ``budget``."""
    order = torch.argsort(tile_count, descending=True, stable=True)
    chunks = ((tile_count[order] + CHUNK - 1) // CHUNK).tolist()
    blocks, i = [], 0
    while i < len(chunks) and chunks[i] > 0:
        n = max(1, budget // chunks[i])
        j = i + n
        while j > len(chunks) or chunks[j - 1] == 0:
            j -= 1
        blocks.append(order[i:j])
        i = j
    return blocks


def to_image(tile_rows, cam):
    """[T, PIX, C] -> [H, W, C]."""
    gx, gy = grid(cam)
    c = tile_rows.shape[-1]
    img = tile_rows.reshape(gy, gx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * TILE, gx * TILE, c)[:cam["H"], :cam["W"]]


def depth_to_normal(cam, depth):
    H, W = cam["H"], cam["W"]
    dev = depth.device
    c2w = torch.linalg.inv(cam["w2c"])
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    x = (xs - W / 2.0) / cam["fx"]
    y = (ys - H / 2.0) / cam["fy"]
    dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ c2w[:3, :3].T
    points = depth[..., None] * dirs + c2w[:3, 3]
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    normal = torch.zeros_like(points)
    normal[1:-1, 1:-1] = n
    return normal


def render(state: dict, cam: dict, d, tile_cap: int, want_walk=False):
    """One view of the deformed surfels: image [H,W,3], the normal maps,
    the distortion map and (``want_walk``) the walk's work rows."""
    g = state["gauss"]
    d_xyz, d_rot, d_scale = d
    means3d = g["xyz"] + d_xyz
    scales = torch.exp(g["scaling"]) + d_scale
    quats = quat_normalize(g["rotation"] + d_rot, eps=1e-12)
    alive = g["alive"]
    opacity = torch.where(alive[:, None], torch.sigmoid(g["opacity"]),
                          0.0)[:, 0]
    sh = torch.cat([g["features_dc"], g["features_rest"]], dim=1)
    dirs = means3d - cam["cam_center"][None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)
                             + 1e-20)
    colors = sh_to_rgb(state["sh_degree"], sh, dirs)
    prep = preprocess(means3d, scales, quats, cam)
    prep["valid"] = prep["valid"] & alive
    opac = torch.where(prep["valid"], opacity, 0.0)
    order, pair_rank, tstart, tcount = bin_pairs(prep, opac, cam)
    n = prep["T"].shape[0]
    feats = torch.cat([prep["T"].reshape(n, 9), prep["center"],
                       prep["normal"], colors, opac[:, None]], dim=-1)
    gx, _ = grid(cam)
    st, last = PlainBlend.apply(feats[order].contiguous(), pair_rank, tstart,
                                torch.clamp_max(tcount, tile_cap), gx)
    st = st.transpose(1, 2)
    bg = torch.zeros(3, device=st.device)
    image = to_image(st[..., ROW_COLOR] + st[..., ROW_T:ROW_T + 1] * bg, cam)
    alpha = to_image(1.0 - st[..., ROW_T:ROW_T + 1], cam)
    rend_normal = to_image(st[..., ROW_NORMAL], cam) @ cam["w2c"][:3, :3]
    med = torch.nan_to_num(to_image(st[..., ROW_MED_D:ROW_MED_D + 1], cam),
                           nan=0.0)
    rend_dist = to_image(st[..., ROW_DIST:ROW_DIST + 1], cam)
    surf_normal = depth_to_normal(cam, med[..., 0]) * alpha.detach()
    out = dict(image=image, rend_normal=rend_normal, surf_normal=surf_normal,
               rend_dist=rend_dist)
    if want_walk:
        out["walk"] = dict(
            n_eval=float(st[..., ROW_N_EVAL].double().sum()),
            n_blend=float(st[..., ROW_N_BLEND].double().sum()),
            n_walk_bwd=float((last.double() + 1.0).sum()),
            n_sorted=n, n_pairs=int(pair_rank.shape[0]),
            n_tiles=int(tstart.shape[0]),
            n_ckpt=int(torch.clamp_min(
                (torch.clamp_max(tcount, tile_cap) + 255) // 256 - 1,
                0).sum()))
    return out


# ----------------------------------------------------------------------
# losses and the training step
# ----------------------------------------------------------------------

def _window(device):
    g = np.exp(-((np.arange(11) - 5) ** 2) / (2 * 1.5 ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(img, win):
    """[H,W,C] through the separable 11x11 window (zero padding): float32
    convolutions, or TF32 under ``precision(True)``."""
    x = img.permute(2, 0, 1)[None].contiguous()
    c = x.shape[1]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = _TF32["on"]
    try:
        x = F.conv2d(x, win.view(1, 1, 11, 1).expand(c, 1, 11, 1),
                     padding=(5, 0), groups=c)
        x = F.conv2d(x, win.view(1, 1, 1, 11).expand(c, 1, 1, 11),
                     padding=(0, 5), groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return x[0].permute(1, 2, 0)


def ssim(a, b):
    win = _window(a.device)
    mu1, mu2 = _blur(a, win), _blur(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(a * a, win) - mu1_sq
    s2 = _blur(b * b, win) - mu2_sq
    s12 = _blur(a * b, win) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu12 + c1) * (2 * s12 + c2))
                      / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))


def expon_lr(lr_init, lr_final, max_steps, step) -> float:
    """The log-linear LR schedule in float32 (get_expon_lr_func, no
    delay)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    t = torch.clamp(f32(float(step)) / max_steps, 0.0, 1.0)
    return float(torch.exp(f32(math.log(lr_init)) * (1 - t)
                           + f32(math.log(lr_final)) * t))


GAUSS_LEAVES = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "feature")
NODE_LEAVES = ("nodes", "node_radius", "node_weight")


def leaves(state: dict) -> dict:
    """The trainable leaves by the names the comparison uses:
    "gauss.<name>", "field.<name>", "nodes.<name>"."""
    out = {f"gauss.{k}": state["gauss"][k] for k in GAUSS_LEAVES}
    out.update({f"field.{k}": v for k, v in state["field"].items()})
    if state.get("nodes") is not None:
        out.update({f"nodes.{k}": state["nodes"][k] for k in NODE_LEAVES})
    return out


def lr_of(name: str, cfg: dict, it: int) -> float:
    tc = cfg["train"]
    xyz_lr = expon_lr(tc["position_lr_init"] * tc["spatial_lr_scale"],
                      tc["position_lr_final"] * tc["spatial_lr_scale"],
                      tc["position_lr_max_steps"], it)
    deform_init = tc["position_lr_init"] * tc["spatial_lr_scale"]
    if name.startswith("field."):
        return expon_lr(deform_init, tc["position_lr_final"],
                        tc["deform_lr_max_steps"], it)
    if name.startswith("nodes."):
        return deform_init
    k = name.split(".", 1)[1]
    return dict(xyz=xyz_lr, features_dc=tc["feature_lr"],
                features_rest=tc["feature_lr"] / 20.0,
                scaling=tc["scaling_lr"] * tc["spatial_lr_scale"],
                rotation=tc["rotation_lr"], opacity=tc["opacity_lr"],
                feature=tc["feature_lr"])[k]


def train_loss(state: dict, cfg: dict, cam: dict, gt, it: int,
               rows: slice = slice(None)):
    """The main-stage loss of one view at iteration ``it``: (1 - l) L1 +
    l (1 - SSIM) over the image's ``rows`` (all of them; the control's
    fault of half the batch left out takes half), the normal-consistency
    and distortion terms.  Returns (loss, l1)."""
    tc = cfg["train"]
    d = deform(state, cfg, cam["time"], it)
    out = render(state, cam, d, cfg["tile_cap"])
    img, gt = out["image"][rows], gt[rows]
    l1 = torch.mean(torch.abs(img - gt))
    loss = (1.0 - tc["lambda_dssim"]) * l1 + tc["lambda_dssim"] * (
        1.0 - ssim(img, gt))
    late = it > tc["normal_dist_from_iter"]
    normal_err = 1.0 - torch.sum(out["rend_normal"] * out["surf_normal"], -1)
    loss = loss + (tc["lambda_normal"] if late else 0.0) * \
        torch.mean(normal_err)
    loss = loss + (tc["lambda_dist"] if late else 0.0) * \
        torch.mean(out["rend_dist"])
    return loss, l1


def train_step(state: dict, opt: dict, cfg: dict, cam: dict, gt, it: int,
               rows: slice = slice(None)):
    """One main-stage step: the loss, autograd, Adam on every leaf in
    place (moments in ``opt``, one count per group).  Returns (l1, the
    gradients by leaf name)."""
    lv = leaves(state)
    for v in lv.values():
        v.requires_grad_(True)
    loss, l1 = train_loss(state, cfg, cam, gt, it, rows)
    names = list(lv)
    grads = torch.autograd.grad(loss, [lv[k] for k in names],
                                allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(lv[k]))
             for k, g in zip(names, grads)}
    b1, b2, eps = 0.9, 0.999, 1e-15
    with torch.no_grad():
        for group in ("gauss", "field", "nodes"):
            keys = [k for k in names if k.startswith(group + ".")]
            if not keys:
                continue
            count = opt["count"].get(group, 0) + 1
            opt["count"][group] = count
            t = torch.tensor(float(count), dtype=torch.float32,
                             device=l1.device)
            c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                              device=l1.device), t)
            c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                              device=l1.device), t)
            for k in keys:
                p, g = lv[k], grads[k]
                m = opt["mu"].setdefault(k, torch.zeros_like(p))
                v = opt["nu"].setdefault(k, torch.zeros_like(p))
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * (g * g))
                p.sub_(lr_of(k, cfg, it) * (m / c1)
                       / (torch.sqrt(v / c2) + eps))
    for v in lv.values():
        v.requires_grad_(False)
    return l1.detach(), grads


@torch.no_grad()
def targets(state: dict, cfg: dict, cams: list) -> list:
    """Each camera's view of ``state`` at its time, [H,W,3] float: the
    training targets of the steps the comparison follows."""
    return [render(state, cam, deform(state, cfg, cam["time"], 10 ** 9),
                   cfg["tile_cap"])["image"] for cam in cams]


def follow(state: dict, cfg: dict, cams: list, gts: list, start_it: int,
           rows: slice = slice(None)) -> dict:
    """The main-stage steps from ``state`` (changed in place) with fresh
    Adam moments, one per (camera, target), from iteration ``start_it``:
    {"l1": each step's L1, "g1": the first gradient as Adam got it (its
    first moment over 1 - beta1), "delta": each leaf's change}, on the
    host."""
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
    p0 = host(leaves(state))
    opt = {"mu": {}, "nu": {}, "count": {}}
    l1s, g1 = [], None
    for k, (cam, gt) in enumerate(zip(cams, gts)):
        l1, _ = train_step(state, opt, cfg, cam, gt, start_it + k, rows)
        l1s.append(float(l1))
        if k == 0:
            g1 = {n: v / (1.0 - 0.9) for n, v in host(opt["mu"]).items()}
    p = host(leaves(state))
    return {"l1": l1s, "g1": g1, "delta": {k: p[k] - p0[k] for k in p0}}


def view_uint8(state: dict, cfg: dict, cam: dict, want_walk=False):
    """A served view as the user receives it: the image at the camera's
    time, as 8-bit levels ([H,W,3] uint8 on the device, truncated as
    ``cli render`` saves it), and the walk's work rows."""
    with torch.no_grad():
        d = deform(state, cfg, cam["time"], 10 ** 9)
        out = render(state, cam, d, cfg["tile_cap"], want_walk=want_walk)
    img8 = torch.clamp(out["image"] * 255.0, 0.0, 255.0).to(torch.uint8)
    return img8, out.get("walk")
