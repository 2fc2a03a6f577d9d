"""Pinhole camera (counterpart of d2dgs_tpu/data/cameras.py).

Geometry fields are float32 tensors on one device; the image size is
plain ints.  The principal point is fixed at (W/2, H/2), like the
reference rasterizer.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import graphics
from ..utils.general import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """w2c maps world -> camera (x_cam = R x + t), row-major."""
    w2c: torch.Tensor          # [4,4] float32
    cam_center: torch.Tensor   # [3] camera position in world space
    fx: torch.Tensor           # 0-d focal in pixels
    fy: torch.Tensor
    time: torch.Tensor         # 0-d normalized timestamp in [0,1]
    H: int
    W: int

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def cx(self):
        return self.W / 2.0

    @property
    def cy(self):
        return self.H / 2.0

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros((), dtype=torch.float32, device=self.device)
        o = torch.ones((), dtype=torch.float32, device=self.device)
        cx = torch.full((), self.cx, dtype=torch.float32, device=self.device)
        cy = torch.full((), self.cy, dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.stack([self.fx, z, cx]),
            torch.stack([z, self.fy, cy]),
            torch.stack([z, z, o]),
        ])


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                H: int, W: int, time: float = 0.0,
                translate=None, scale: float = 1.0,
                device="cuda") -> Camera:
    """Build a Camera from reference-style (R, T, FoV) camera infos."""
    dev = resolve_device(device)
    w2c = graphics.get_world2view(R, t, translate=translate, scale=scale)
    c2w = np.linalg.inv(w2c)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return Camera(
        w2c=f32(w2c),
        cam_center=f32(c2w[:3, 3]),
        fx=f32(graphics.fov2focal(fovx, W)),
        fy=f32(graphics.fov2focal(fovy, H)),
        time=f32(time),
        H=int(H), W=int(W),
    )


def orbit_camera(azimuth: float, elevation: float, radius: float,
                 fov: float, H: int, W: int, time: float = 0.0,
                 target=(0.0, 0.0, 0.0), device="cuda") -> Camera:
    """Look-at orbit camera for tests and trajectory rendering."""
    target = np.asarray(target, np.float64)
    ce, se = math.cos(elevation), math.sin(elevation)
    ca, sa = math.cos(azimuth), math.sin(azimuth)
    eye = target + radius * np.array([ce * sa, se, ce * ca])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # camera axes: x=right, y=down (image y grows down), z=forward
    R_w2c = np.stack([right, down, fwd], axis=0)
    t = -R_w2c @ eye
    # make_camera expects R = c2w rotation (it transposes internally)
    return make_camera(R_w2c.T, t, fov, fov, H, W, time=time, device=device)
