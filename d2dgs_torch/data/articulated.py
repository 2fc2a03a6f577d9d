"""Procedural articulated scene with exact ground-truth geometry
(counterpart of d2dgs_tpu/data/articulated.py).

An articulated figure (torso, head, two 2-segment arms and legs) built
from parametric surfaces, a thin waving cape and a thin hoop held at the
left hand, with high-frequency procedural albedo and smooth non-rigid
jumping-jack motion.  ``surfel_positions(t)`` returns the exact animated
surface samples at any time: they are the splats rendered into the
training images and the reference geometry a mesh's chamfer distance is
scored against.

The scene itself is host numpy, a copy of the JAX package's generator,
so a seed gives bitwise the same arrays in both packages.
``gt_gaussians`` builds the port's ``GaussianParams`` on a device and
``make_articulated_dataset`` renders the multi-view video through the
port's ``render`` (the work-queue forward, K1, on the card).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# ----------------------------------------------------------------------
# Surface sampling
# ----------------------------------------------------------------------


def _sample_ellipsoid(rng, n, radii):
    """Uniform-ish samples on an ellipsoid surface; returns (pos, normal,
    local uv-ish coords for texturing)."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * radii
    nrm = v / radii  # gradient of implicit fn
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm, pos.copy()


def _sample_capsule(rng, n, radius, length):
    """Capsule: cylinder along +z from 0..length, hemispherical caps."""
    area_cyl = 2 * np.pi * radius * length
    area_caps = 4 * np.pi * radius ** 2
    n_cyl = int(n * area_cyl / (area_cyl + area_caps))
    n_cap = n - n_cyl
    phi = rng.uniform(0, 2 * np.pi, n_cyl)
    z = rng.uniform(0, length, n_cyl)
    pc = np.stack([radius * np.cos(phi), radius * np.sin(phi), z], 1)
    nc = np.stack([np.cos(phi), np.sin(phi), np.zeros(n_cyl)], 1)
    v = rng.randn(n_cap, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    top = v[:, 2] >= 0
    ps = v * radius + np.where(top[:, None], [0, 0, 1], [0, 0, 0]) * length
    ns = v
    pos = np.concatenate([pc, ps], 0)
    nrm = np.concatenate([nc, ns], 0)
    return pos, nrm, pos.copy()


def _sample_plate(rng, n, w, h, thick):
    """Thin rectangular plate in the xz plane (width w along x, height h
    along -z hanging down), thickness `thick` along y."""
    x = rng.uniform(-w / 2, w / 2, n)
    z = rng.uniform(-h, 0.0, n)
    side = rng.randint(0, 2, n) * 2 - 1
    y = side * thick / 2
    pos = np.stack([x, y, z], 1)
    nrm = np.stack([np.zeros(n), side.astype(np.float64), np.zeros(n)], 1)
    return pos, nrm, pos.copy()


def _sample_torus(rng, n, R, r):
    """Torus in the xy plane."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cx = np.stack([R * np.cos(u), R * np.sin(u), np.zeros(n)], 1)
    nrm = np.stack([np.cos(v) * np.cos(u), np.cos(v) * np.sin(u),
                    np.sin(v)], 1)
    pos = cx + r * nrm
    return pos, nrm, pos.copy()


# ----------------------------------------------------------------------
# Texture
# ----------------------------------------------------------------------

_PART_HUES = {
    "torso":  (0.85, 0.30, 0.25),
    "head":   (0.95, 0.80, 0.55),
    "arm_ul": (0.25, 0.55, 0.85),
    "arm_ll": (0.30, 0.80, 0.80),
    "arm_ur": (0.85, 0.55, 0.20),
    "arm_lr": (0.90, 0.75, 0.25),
    "leg_ul": (0.35, 0.70, 0.35),
    "leg_ll": (0.55, 0.85, 0.40),
    "leg_ur": (0.45, 0.35, 0.75),
    "leg_lr": (0.65, 0.45, 0.85),
    "cape":   (0.90, 0.35, 0.60),
    "hoop":   (0.95, 0.90, 0.30),
}


def _texture(part: str, local: np.ndarray, freq: float) -> np.ndarray:
    """High-frequency procedural albedo: hue x 3-D checker x stripe."""
    base = np.asarray(_PART_HUES[part])
    s = np.sin(freq * local)
    checker = 0.5 + 0.5 * np.sign(s[:, 0] * s[:, 1] * s[:, 2] + 1e-12)
    stripe = 0.5 + 0.5 * np.sin(2.3 * freq * (local[:, 0] + local[:, 2]))
    m = (0.35 + 0.55 * checker * 0.7 + 0.3 * stripe)[:, None]
    col = np.clip(base[None, :] * m, 0.02, 1.0)
    # a contrasting dot pattern on top (extra high-frequency detail)
    dots = (np.sin(3.1 * freq * local[:, 0])
            * np.sin(3.7 * freq * local[:, 1])
            * np.sin(2.9 * freq * local[:, 2])) > 0.55
    col[dots] = 1.0 - col[dots]
    return col


# ----------------------------------------------------------------------
# Skeleton / articulation
# ----------------------------------------------------------------------


def _rot(axis: str, a):
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class _Part(NamedTuple):
    name: str
    pos: np.ndarray      # [K,3] local rest positions
    nrm: np.ndarray      # [K,3] local normals
    col: np.ndarray      # [K,3] albedo
    # transform(t) -> (R[3,3], T[3]) world placement of the local frame;
    # for two-segment limbs the callable returns per-point blended
    # rotations ([K,3,3], [K,3]) instead.
    transform: Callable


def _chain(parent_R, parent_T, local_R, local_T):
    return parent_R @ local_R, parent_R @ local_T + parent_T


def build_figure(rng: np.random.RandomState, n_surfels: int):
    """Assemble the articulated figure; returns (parts, motion_params).
    Proportions: ~1.8 units tall, centred near the origin."""
    budget = {
        "torso": 0.16, "head": 0.08, "cape": 0.10, "hoop": 0.08,
        "arm_ul": 0.07, "arm_ll": 0.07, "arm_ur": 0.07, "arm_lr": 0.07,
        "leg_ul": 0.075, "leg_ll": 0.075, "leg_ur": 0.075, "leg_lr": 0.075,
    }
    parts = []

    def mk(name, sampler, freq, *a):
        k = max(int(n_surfels * budget[name]), 16)
        pos, nrm, local = sampler(rng, k, *a)
        col = _texture(name, local, freq)
        return name, pos, nrm, col

    # ---- motion curves (smooth, nonzero at every t in [0,1]) ----
    def arm_angle(t, side):
        # jumping-jack swing: down (~0.3 rad) to overhead (~2.4 rad)
        return side * (1.35 + 1.05 * np.sin(2 * np.pi * t + 0.6))

    def elbow_angle(t, side):
        return side * (0.5 + 0.35 * np.sin(4 * np.pi * t + 1.1))

    def leg_angle(t, side):
        return side * (0.28 + 0.22 * np.sin(2 * np.pi * t + 0.6))

    def knee_angle(t, side):
        return side * (-0.25 - 0.2 * np.sin(4 * np.pi * t + 0.3))

    def bob(t):
        return 0.12 * np.sin(4 * np.pi * t + 0.8)

    def sway(t):
        return 0.08 * np.sin(2 * np.pi * t + 2.0)

    # ---- torso (root) ----
    def torso_tf(t):
        R = _rot("y", sway(t))
        T = np.array([0.0, bob(t), 0.0])
        return R, T

    parts.append(_Part(*mk("torso", _sample_ellipsoid, 21.0,
                           np.array([0.26, 0.42, 0.17])), torso_tf))

    def head_tf(t):
        R0, T0 = torso_tf(t)
        return _chain(R0, T0, _rot("z", 0.15 * np.sin(2 * np.pi * t)),
                      np.array([0.0, 0.55, 0.0]))

    parts.append(_Part(*mk("head", _sample_ellipsoid, 34.0,
                           np.array([0.14, 0.16, 0.14])), head_tf))

    # ---- two-segment limbs with linear-blend skinning at the joint ----
    # Capsules are sampled along local +z.  A fixed pre-rotation
    # R_x(pi/2) maps +z to world "down" (-y); the swing then rotates in
    # the frontal (xy) plane about z (jumping-jack style), and the
    # elbow/knee bend is a flexion about the segment-local y axis (which
    # the pre-rotation aligns with world z — motion stays frontal).
    _PRE = _rot("x", np.pi / 2)

    def limb(name_u, name_l, anchor, swing, bend, seg_r, seg_l):
        nu, pu, nnu, cu = mk(name_u, _sample_capsule, 55.0, seg_r, seg_l)
        nl, pl, nnl, cl = mk(name_l, _sample_capsule, 55.0,
                             seg_r * 0.8, seg_l * 0.95)

        def tf_u(t):
            R0, T0 = torso_tf(t)
            return _chain(R0, T0, _rot("z", swing(t)) @ _PRE,
                          np.asarray(anchor, np.float64))

        def tf_l(t):
            Ru, Tu = tf_u(t)
            return _chain(Ru, Tu, _rot("y", bend(t)),
                          np.array([0.0, 0.0, seg_l]))

        def skinned_u(t):
            """Blend toward the lower-segment frame near the joint end
            (z close to seg_l) — smooth non-rigid flesh, not a hinge."""
            Ru, Tu = tf_u(t)
            Rl, Tl = tf_l(t)
            z = pu[:, 2] / seg_l
            w = np.clip((z - 0.75) / 0.25, 0.0, 1.0) * 0.5  # [K]
            # blend world placements of the SAME local point
            pw_u = pu @ Ru.T + Tu
            pw_l = (pu - [0, 0, seg_l]) @ Rl.T + Tl
            pos = pw_u * (1 - w[:, None]) + pw_l * w[:, None]
            nw_u = nnu @ Ru.T
            nw_l = nnu @ Rl.T
            nrm = nw_u * (1 - w[:, None]) + nw_l * w[:, None]
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-12
            return pos, nrm

        return (_Part(nu, pu, nnu, cu, ("skin", skinned_u)),
                _Part(nl, pl, nnl, cl, tf_l)), tf_l

    def arm(side, name_u, name_l):
        sgn = 1.0 if side == "l" else -1.0
        return limb(
            name_u, name_l,
            anchor=[sgn * 0.30, 0.34, 0.0],
            swing=lambda t: arm_angle(t, sgn),
            bend=lambda t: elbow_angle(t, sgn),
            seg_r=0.055, seg_l=0.34)

    def leg(side, name_u, name_l):
        sgn = 1.0 if side == "l" else -1.0
        return limb(
            name_u, name_l,
            anchor=[sgn * 0.13, -0.38, 0.0],
            swing=lambda t: leg_angle(t, sgn),
            bend=lambda t: knee_angle(t, sgn),
            seg_r=0.07, seg_l=0.42)

    (arm_l, tf_arm_l_lower) = arm("l", "arm_ul", "arm_ll")
    (arm_r, _) = arm("r", "arm_ur", "arm_lr")
    (leg_l, _) = leg("l", "leg_ul", "leg_ll")
    (leg_r, _) = leg("r", "leg_ur", "leg_lr")
    for p in arm_l + arm_r + leg_l + leg_r:
        parts.append(p)

    # ---- thin cape hanging from the shoulders, waving ----
    # plate local: hangs along -z; pre-rotate -z to world -y (R_x(-pi/2))
    # plus a time-varying backward tilt.
    nc, pc, nnc, cc = mk("cape", _sample_plate, 40.0, 0.56, 0.62, 0.012)

    def cape_skin(t):
        R0, T0 = torso_tf(t)
        wave = 0.30 * np.sin(2 * np.pi * t + 0.9)
        R, T = _chain(R0, T0, _rot("x", -np.pi / 2 + 0.30 + wave),
                      np.array([0.0, 0.36, -0.18]))
        # secondary ripple grows down the cape (non-rigid flutter);
        # displace along the plate normal (local y)
        z = -pc[:, 2] / 0.62
        pos_local = pc.copy()
        pos_local[:, 1] += 0.08 * np.sin(4 * np.pi * t + 3.0) * z ** 2
        pos = pos_local @ R.T + T
        nrm = nnc @ R.T
        return pos, nrm

    parts.append(_Part(nc, pc, nnc, cc, ("skin", cape_skin)))

    # ---- thin hoop held at the left hand ----
    nh, ph, nnh, ch = mk("hoop", _sample_torus, 60.0, 0.16, 0.02)

    def hoop_tf(t):
        # follows the left lower-arm tip, turning about its own axis.
        # The turn rate is deliberately sub-Nyquist for the dataset's
        # 8 time samples (a full 2*pi spin aliased at 45 deg/frame and
        # made the hoop unlearnable for ANY method — mesh gt->pred
        # 0.127 at t=0.5 vs 0.03 elsewhere)
        Rl, Tl = tf_arm_l_lower(t)
        return _chain(Rl, Tl,
                      _rot("z", 0.5 * np.pi * t) @ _rot("x", 0.6),
                      np.array([0.0, 0.0, 0.40]))

    parts.append(_Part(nh, ph, nnh, ch, hoop_tf))
    return parts


# ----------------------------------------------------------------------
# Public dataset API
# ----------------------------------------------------------------------


class ArticulatedScene(NamedTuple):
    parts: list
    n_surfels: int
    surfel_colors: np.ndarray   # [K,3]
    surfel_radius: np.ndarray   # [K] isotropic world radius

    def surfel_positions(self, t: float):
        """Exact GT surface samples at time t: ([K,3] pos, [K,3] normal)."""
        ps, ns = [], []
        for p in self.parts:
            if isinstance(p.transform, tuple) and p.transform[0] == "skin":
                pos, nrm = p.transform[1](t)
            else:
                R, T = p.transform(t)
                pos = p.pos @ R.T + T
                nrm = p.nrm @ R.T
            ps.append(pos)
            ns.append(nrm)
        return (np.concatenate(ps, 0).astype(np.float32),
                np.concatenate(ns, 0).astype(np.float32))


def make_scene(seed: int = 0, n_surfels: int = 60_000) -> ArticulatedScene:
    rng = np.random.RandomState(seed)
    parts = build_figure(rng, n_surfels)
    cols = np.concatenate([p.col for p in parts], 0).astype(np.float32)
    k = cols.shape[0]
    # surfel radius from local sampling density: ~sqrt(area/K) per part.
    rad = []
    for p in parts:
        # nearest-neighbour spacing estimate on a subsample
        m = min(len(p.pos), 512)
        sub = p.pos[rng.choice(len(p.pos), m, replace=False)]
        d2 = ((sub[:, None] - sub[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        spacing = float(np.sqrt(np.median(d2.min(1))))
        rad.append(np.full(len(p.pos), 0.9 * spacing, np.float32))
    return ArticulatedScene(parts, k, cols, np.concatenate(rad, 0))


def gt_gaussians(scene: ArticulatedScene, t: float, capacity: int = 0,
                 device="cuda"):
    """The port's ``GaussianParams`` for the GT surfels at time t on
    ``device``, render-ready: SH degree 0, opacity 0.95, each surfel's
    plane perpendicular to its normal; ``capacity`` pads with dead slots
    holding identity quaternions."""
    from ..models.gaussians import GaussianParams
    from ..utils.general import resolve_device
    from ..utils.quaternion import rotmat_to_quat
    from ..utils.sh import rgb_to_sh

    dev = resolve_device(device)
    pos, nrm = scene.surfel_positions(t)
    k = pos.shape[0]
    cap = capacity or k
    # a frame whose third column is the normal
    a = np.where(np.abs(nrm[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]],
                 [[1.0, 0.0, 0.0]])
    u = np.cross(a, nrm)
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
    v = np.cross(nrm, u)
    R = np.stack([u, v, nrm], axis=2)  # columns u, v, n
    quat = rotmat_to_quat(torch.from_numpy(R.astype(np.float32))).numpy()
    inv_sig = np.log(0.95 / 0.05)

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:k] = x
        return torch.from_numpy(out).to(dev)

    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0  # identity quats in dead slots (NaN-safe normalize)
    rot[:k] = quat
    dc = rgb_to_sh(torch.from_numpy(scene.surfel_colors))[:, None, :]
    return GaussianParams(
        xyz=pad(pos),
        features_dc=pad(dc.numpy()),
        features_rest=torch.zeros((cap, 0, 3), dtype=torch.float32,
                                  device=dev),
        scaling=pad(np.log(np.stack([scene.surfel_radius] * 2, 1))),
        rotation=torch.from_numpy(rot).to(dev),
        opacity=pad(np.full((k, 1), inv_sig)),
        feature=torch.zeros((cap, 0), dtype=torch.float32, device=dev),
        alive=torch.arange(cap, device=dev) < k,
        active_sh_degree=0, with_motion_mask=False)


@torch.no_grad()
def make_articulated_dataset(seed: int, n_cams: int, n_times: int,
                             H: int, W: int, n_surfels: int = 60_000,
                             bg=None, elevations=(0.35, 0.0, -0.25),
                             cfg=None, radius: float = 3.6, device="cuda"):
    """Render the GT multi-view video through the port's ``render``.
    Returns (cams, images, alphas, scene, times): cameras on ``device``,
    images [H,W,3] and alphas [H,W,1] as host numpy.  The camera jitter
    comes from ``np.random.RandomState(seed + 1)``, as in the JAX package.
    Raises if a render drops pairs past ``cfg.tile_cap``."""
    from ..config import RasterConfig
    from ..render.renderer import render
    from ..utils.general import resolve_device
    from .cameras import orbit_camera

    dev = resolve_device(device)
    scene = make_scene(seed, n_surfels)
    bg = np.zeros(3, np.float32) if bg is None else np.asarray(bg)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    times = [i / max(n_times - 1, 1) for i in range(n_times)]
    if cfg is None:
        # tile_cap 8192: at 800x800 the busiest GT tile stacks more than
        # 4096 surfels (edge-on limbs); the port has no pair_cap, so the
        # overflow count is the tile_cap truncation alone
        cfg = RasterConfig(tile_cap=8192, chunk=64)

    cams, images, alphas = [], [], []
    rng = np.random.RandomState(seed + 1)
    for ti, t in enumerate(times):
        g = gt_gaussians(scene, t, device=dev)
        for ci in range(n_cams):
            az = 2 * np.pi * ci / n_cams + 0.4 * (ti / max(n_times, 1)) \
                + 0.03 * rng.randn()
            el = elevations[ci % len(elevations)] + 0.02 * rng.randn()
            cam = orbit_camera(az, el, radius, fov=0.72, H=H, W=W,
                               time=float(t), device=dev)
            out = render(cam, g, bg_t, cfg=cfg)
            ov = int(out.overflow)
            if ov != 0:
                raise AssertionError(
                    f"GT render overflow: {ov} pairs past tile_cap "
                    f"{cfg.tile_cap}")
            cams.append(cam)
            images.append(out.image.cpu().numpy())
            alphas.append(out.alpha.cpu().numpy())
    return cams, images, alphas, scene, times
