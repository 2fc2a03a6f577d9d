"""The cell's inputs, made from the seed: the surfel scene, the
deformation field's weights, the cameras and times.  Both sides, the
port and the plain reference, are handed the same tensors; neither makes
its own.

Weights are drawn on the device from one ``torch.Generator`` in a few
large calls (one uniform and one normal buffer, sliced), in float32, the
type they are trained and served in.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
SH_C0 = 0.28209479177387814


def seeds(seed: int) -> dict:
    """Independent sub-seeds of the run's ``--seed`` (any size)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 63))
    names = ("weights", "colours", "perturb", "sample", "fps")
    return {n: int(s.generate_state(1, np.uint32)[0])
            for n, s in zip(names, ss.spawn(len(names)))}


# ----------------------------------------------------------------------
# cameras
# ----------------------------------------------------------------------

def orbit_w2c(azimuth: float, elevation: float, radius: float):
    """World -> camera of a look-at camera on the orbit sphere around the
    origin (x right, y down, z forward)."""
    ce, se = math.cos(elevation), math.sin(elevation)
    ca, sa = math.cos(azimuth), math.sin(azimuth)
    eye = radius * np.array([ce * sa, se, ce * ca])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def camera(azimuth, elevation, traffic: dict, time: float, device) -> dict:
    """The plain camera record both sides build their camera from."""
    H, W = traffic["height"], traffic["width"]
    w2c = orbit_w2c(azimuth, elevation, traffic["orbit_radius"])
    c2w = np.linalg.inv(w2c)
    f = traffic["width"] / (2.0 * math.tan(traffic["fov"] / 2.0))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return dict(w2c=f32(w2c), cam_center=f32(c2w[:3, 3]), fx=f32(f),
                fy=f32(f), time=f32(time), H=int(H), W=int(W))


def view_pool(traffic: dict, device) -> list:
    """The traffic's fixed set of (camera, t): ``views`` cameras spread
    over the orbit band (golden-angle azimuths, elevations stratified in
    ``elevation``) with times k / (views - 1) in a fixed shuffle.  The
    same for every seed, and so is the order the traffic's fixed
    ``sampler_seed``/``order_seed`` walks it in: every run has the same
    work, the seed changes the scene's colours, weights and
    perturbation."""
    n = traffic["views"]
    lo, hi = traffic["elevation"]
    golden = math.pi * (3.0 - math.sqrt(5.0))
    times = np.random.RandomState(0).permutation(n) / max(n - 1, 1)
    return [camera((k * golden) % (2 * math.pi),
                   lo + (hi - lo) * ((k * 0.6180339887498949) % 1.0),
                   traffic, float(times[k]), device) for k in range(n)]


# ----------------------------------------------------------------------
# the scene and the field
# ----------------------------------------------------------------------

def load_surfels(cfg: dict):
    with np.load(HERE / cfg["scene"]) as z:
        return z["xyz"], z["scaling"], z["opacity"]


def field_shapes(cfg: dict) -> list:
    """(name, shape, init, scale) of the field's leaves
    (``fields/<deform_type>.py``)."""
    from .fields import field
    return field(cfg["deform_type"]).shapes(cfg)


def make_field(cfg: dict, seed: int, device) -> dict:
    shapes = field_shapes(cfg)
    n_u = sum(math.prod(s) for _, s, k, _ in shapes if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in shapes if k == "n")
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, kind, scale in shapes:
        k = math.prod(shape)
        if kind == "u":
            out[name] = (uni[iu:iu + k] * scale).reshape(shape).clone()
            iu += k
        elif kind == "n":
            out[name] = (nor[inn:inn + k] * scale).reshape(shape).clone()
            inn += k
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def make_state(cfg: dict, seed: int, device) -> dict:
    """The scene as plain tensors: the converged surfels at capacity
    ``gaussian_capacity`` with colours and SH rest drawn from the seed,
    the field's weights and what else the field holds (the node field's
    control nodes, farthest-point samples of the surfels from a seeded
    start)."""
    from .fields import field
    s = seeds(seed)
    xyz, scaling, opacity = load_surfels(cfg)
    n, cap = xyz.shape[0], cfg["gaussian_capacity"]
    k_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(s["colours"])
    rgb = torch.rand((n, 3), generator=gen, device=device)
    rest = 0.05 * torch.randn((n, k_rest, 3), generator=gen, device=device)

    def pad(x, tail):
        out = torch.zeros((cap,) + tail, dtype=torch.float32, device=device)
        out[:n] = x
        return out

    g = dict(xyz=pad(f32(xyz), (3,)),
             features_dc=pad(((rgb - 0.5) / SH_C0)[:, None, :], (1, 3)),
             features_rest=pad(rest, (k_rest, 3)),
             scaling=pad(f32(scaling), (2,)),
             rotation=torch.zeros((cap, 4), device=device),
             opacity=pad(f32(opacity), (1,)),
             feature=torch.full((cap, cfg["hyper_dim"] + 1), -1e-2,
                                device=device),
             alive=torch.zeros((cap,), dtype=torch.bool, device=device))
    g["rotation"][:, 0] = 1.0
    g["feature"][:, -1] = 0.0
    g["alive"][:n] = True
    return dict(gauss=g, field=make_field(cfg, s["weights"], device),
                sh_degree=cfg["sh_degree"],
                nodes=field(cfg["deform_type"]).extra_state(cfg, g, n, s,
                                                            device))


def copy_state(state: dict, device) -> dict:
    """A copy of ``state`` on ``device``."""
    cp = lambda d: None if d is None else {
        k: v.to(device, copy=True) for k, v in d.items()}
    return dict(state, gauss=cp(state["gauss"]), field=cp(state["field"]),
                nodes=cp(state["nodes"]))


def perturbed(state: dict, seed: int, perturb: dict, device) -> dict:
    """A copy of ``state`` on ``device`` with the live surfels' colours
    and opacity logits moved by normal noise drawn from the seed of std
    ``perturb["features_dc"]`` and ``perturb["opacity"]`` (phase 4 of
    chip_smoke.py)."""
    out = copy_state(state, device)
    g = out["gauss"]
    n = int(g["alive"].sum())
    pg = torch.Generator(device=device).manual_seed(seeds(seed)["perturb"])
    for k in ("features_dc", "opacity"):
        noise = torch.randn((n,) + g[k].shape[1:], generator=pg,
                            device=device)
        g[k][:n] += perturb[k] * noise
    return out
