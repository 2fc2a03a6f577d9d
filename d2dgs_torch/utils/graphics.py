"""Camera / projection math in numpy (counterpart of d2dgs_tpu/utils/graphics.py).

World-to-camera maps x_cam = R_w2c @ x_world + t; matrices are kept in
ordinary row-major math convention.
"""
from __future__ import annotations

import math

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate: np.ndarray | None = None,
                   scale: float = 1.0) -> np.ndarray:
    """Build the 4x4 world->camera matrix.

    `R` is the camera-to-world rotation (the reference stores it
    transposed, so Rt[:3,:3] = R.T maps world->cam).  `translate`/`scale`
    recentre the camera ring (NeRF++ normalization).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        tr = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + tr) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)
