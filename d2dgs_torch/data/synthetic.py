"""Procedural test scenes: random Gaussian clouds and an animated cluster
(counterpart of d2dgs_tpu/data/synthetic.py).

The JAX package draws with ``jax.random``; here every draw comes from a
``np.random.RandomState`` seeded by the caller, so a seed gives the same
scene on every device.  The two packages' scenes from one seed differ.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.general import resolve_device
from .cameras import Camera, orbit_camera


def random_gaussians(seed: int, n: int, extent: float = 1.0,
                     scale_range=(0.02, 0.12), opacity_range=(0.3, 1.0),
                     device="cuda"):
    """(means [n,3], scales [n,2], quats [n,4], opacity [n], colours
    [n,3]) float32 tensors on ``device``."""
    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    means = rs.uniform(-extent, extent, size=(n, 3))
    scales = rs.uniform(*scale_range, size=(n, 2))
    quats = rs.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rs.uniform(*opacity_range, size=(n,))
    colors = rs.uniform(size=(n, 3))
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (means, scales, quats, opac, colors))


def blend_test_scene(kind: str, n_packed: int = 700):
    """The blend kernels' check scenes, seen from ``orbit_camera(0.4, 0.3,
    3.0, fov=0.8)`` at 48x64: "pallas", 160 random splats (the shapes of
    the JAX package's blend-kernel tests); "opaque", the same at opacity
    0.999 (early termination); "packed", ``n_packed`` splats packed near
    the view centre (at 700 its busiest tile holds 626 pairs, three
    256-pair backward segments).  Returns (means, scales, quats, opacity,
    colours) float32 numpy arrays."""
    if kind not in ("pallas", "opaque", "packed"):
        raise ValueError(f"unknown blend test scene {kind!r}")
    n, spread, bias = (n_packed, 0.15, -1.0) if kind == "packed" else \
        (160, 0.5, 1.0)
    rs = np.random.RandomState(0)
    means = rs.normal(size=(n, 3)) * spread
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + bias)))
    if kind == "opaque":
        opac = np.full(n, 0.999)
    colors = rs.uniform(size=(n, 3))
    return tuple(np.asarray(a, np.float32)
                 for a in (means, scales, quats, opac, colors))


def test_camera(H: int = 64, W: int = 64, radius: float = 4.0,
                azimuth: float = 0.3, elevation: float = 0.2,
                time: float = 0.0, device="cuda") -> Camera:
    return orbit_camera(azimuth, elevation, radius, fov=0.8, H=H, W=W,
                        time=time, device=device)


def rigid_motion(means: torch.Tensor, t, amp: float = 0.35) -> torch.Tensor:
    """The animated scene's motion at time t: a rotation about the y axis
    by amp * (2t - 1) and a vertical shift of 0.25 * (2t - 1), both linear
    in t so they are non-zero at every sampled time."""
    ang = amp * (2.0 * float(t) - 1.0)
    c, s = np.cos(ang), np.sin(ang)
    R = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32,
                     device=means.device)
    dy = 0.25 * (2.0 * float(t) - 1.0)
    shift = torch.tensor([0.0, dy, 0.0], device=means.device)
    return means @ R.T + shift


def animated_scene(seed: int, n: int = 24, amp: float = 0.35,
                   device="cuda"):
    """A compact cluster of Gaussians moved by ``rigid_motion``.  Returns
    ((means, scales, quats, opacity, colours), motion(t) -> means at t)."""
    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    means = rs.uniform(-0.5, 0.5, size=(n, 3))
    scales = rs.uniform(0.08, 0.18, size=(n, 2))
    quats = rs.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rs.uniform(0.6, 0.95, size=(n,))
    colors = rs.uniform(0.1, 0.9, size=(n, 3))
    params = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in (means, scales, quats, opac, colors))
    return params, (lambda t: rigid_motion(params[0], t, amp))


def video_cameras(n_cams: int = 8, n_times: int = 4, H: int = 64,
                  W: int = 64, device="cuda") -> list[Camera]:
    """Camera i looks from azimuth 2 pi (i // n_times) / n_cams (jittered
    from seed 0) at time (i % n_times) / (n_times - 1), radius 4, fov 0.9,
    as the JAX package's make_video_dataset places them."""
    rng = np.random.RandomState(0)
    cams = []
    for i in range(n_cams * n_times):
        t = (i % n_times) / max(n_times - 1, 1)
        az = 2 * np.pi * (i // n_times) / n_cams + 0.05 * rng.randn()
        cams.append(orbit_camera(az, 0.3, 4.0, fov=0.9, H=H, W=W, time=t,
                                 device=device))
    return cams


@torch.no_grad()
def make_video_dataset(seed: int, n_cams: int = 8, n_times: int = 4,
                       H: int = 64, W: int = 64, n_gauss: int = 24,
                       device="cuda"):
    """Render a ground-truth multi-view video of ``animated_scene`` with
    the dense renderer.  Returns (cameras, images [H,W,3] numpy,
    init_points [256,3], init_colors [256,3])."""
    from ..ops.dense_raster import rasterize_dense
    (means, scales, quats, opac, colors), motion = animated_scene(
        seed, n=n_gauss, device=device)
    cams = video_cameras(n_cams, n_times, H, W, device=device)
    imgs = []
    for cam in cams:
        img, *_ = rasterize_dense(motion(cam.time), scales, quats, opac,
                                  colors, cam,
                                  torch.zeros(3, device=means.device))
        imgs.append(img.cpu().numpy())
    rs = np.random.RandomState(seed + 1)
    init_pts = rs.uniform(-1.0, 1.0, size=(256, 3)).astype(np.float32)
    init_cols = rs.uniform(size=(256, 3)).astype(np.float32)
    return cams, imgs, init_pts, init_cols


def single_facing_gaussian(cam: Camera, depth: float = 4.0,
                           scale: float = 0.3, opacity: float = 0.8):
    """One surfel centred on the optical axis, facing the camera."""
    c2w = np.linalg.inv(cam.w2c.cpu().numpy().astype(np.float64))
    center = c2w[:3, 3] + depth * c2w[:3, 2]
    # the surfel normal along the camera z axis: a rotation whose third
    # column is the view direction
    z = c2w[:3, 2]
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    # rotation matrix -> quaternion (wxyz)
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    q = np.array([w,
                  (R[2, 1] - R[1, 2]) / (4 * w),
                  (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=cam.device)
    return (f32(center[None]), f32([[scale, scale]]), f32(q[None]),
            f32([opacity]), f32([[0.2, 0.5, 0.9]]))


def write_dnerf_scene(root: str, splits: dict, name: str = "r_{k}") -> None:
    """Write a D-NeRF-format scene that ``data/dnerf.load_scene`` reads:
    ``splits`` maps "train"/"test" to lists of (Camera, [H,W,4] RGBA in
    [0,1]); frame k becomes ``<split>/<name.format(k=k)>.png`` with its
    camera in ``transforms_<split>.json`` (the Blender c2w, OpenGL axes).
    The reader orders frames by the integer after the last underscore,
    and a flow file names its target frame by the text after its last
    underscore (``data/flow.target_name``), so a scene that carries flow
    files names its frames by the integer alone (``name="{k:03d}"``)."""
    import json
    import os

    from PIL import Image
    for split, frames in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        entries = []
        for k, (cam, rgba) in enumerate(frames):
            c2w = np.linalg.inv(cam.w2c.cpu().numpy().astype(np.float64))
            c2w[:3, 1:3] *= -1                   # OpenCV -> OpenGL axes
            stem = name.format(k=k)
            Image.fromarray((np.clip(rgba, 0, 1) * 255).round().astype(
                np.uint8)).save(os.path.join(root, split, f"{stem}.png"))
            entries.append({"file_path": f"./{split}/{stem}",
                            "time": float(cam.time),
                            "transform_matrix": c2w.tolist()})
        cam = frames[0][0]
        fovx = 2 * np.arctan(cam.W / (2 * float(cam.fx)))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": float(fovx), "frames": entries}, fh)


def write_flow_file(root: str, stem: str, target: str, flow_px: np.ndarray,
                    mask: np.ndarray | None = None) -> str:
    """Write one RAFT-format flow file that ``data/flow.load_flow`` reads:
    ``raft_neighbouring/<stem>.to_<target>.npy`` holding ``flow_px``
    ([h,w,2] float32 pixel displacements toward frame ``target``) and,
    with ``mask`` ([h,w,2] in {0,1}: cycle consistency, occlusion),
    ``raft_masks/<stem>.to_<target>.png``.  Returns the flow file's
    path."""
    import os

    from PIL import Image
    base = f"{stem}.to_{target}"
    os.makedirs(os.path.join(root, "raft_neighbouring"), exist_ok=True)
    path = os.path.join(root, "raft_neighbouring", base + ".npy")
    np.save(path, np.asarray(flow_px, np.float32))
    if mask is not None:
        os.makedirs(os.path.join(root, "raft_masks"), exist_ok=True)
        m = (np.asarray(mask) > 0).astype(np.uint8) * 255
        rgb = np.concatenate([m, np.zeros_like(m[..., :1])], -1)
        Image.fromarray(rgb).save(os.path.join(root, "raft_masks",
                                               base + ".png"))
    return path
