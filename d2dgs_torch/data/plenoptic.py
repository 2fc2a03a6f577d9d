"""Neu3D / Plenoptic-video dataset reader (counterpart of
d2dgs_tpu/data/plenoptic.py: poses_bounds.npy and per-camera frame
folders, readCamerasFromNpy / readPlenopticVideoDataset,
scene/dataset_readers.py:777-862).  Cameras are built on ``device``.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..utils import graphics
from .cameras import make_camera
from .dnerf import CameraSample, SceneInfo, get_nerfpp_norm


def _poses_from_bounds(poses_bounds: np.ndarray) -> tuple:
    """LLFF poses_bounds rows -> ([V,4,4] c2w in OpenCV convention,
    (H, W, focal)). Axis shuffle per dataset_readers.py:785-791:
    columns (down, right, back) -> (right, up, back), then y/z flip."""
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, -1]
    m = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]],
                       axis=-1)
    bottom = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4),
                     (m.shape[0], 1, 1))
    c2w = np.concatenate([m, bottom], axis=1) @ np.diag([1, -1, -1, 1.0])
    return c2w, (int(H), int(W), float(focal))


def load_plenoptic_scene(path: str, eval_split: bool = True,
                         num_images: int = 24, hold_id=(0,),
                         num_init_points: int = 100_000,
                         seed: int = 0, device="cuda") -> SceneInfo:
    from PIL import Image

    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    c2w_all, (H, W, focal) = _poses_from_bounds(poses_bounds)
    video_paths = sorted(glob.glob(os.path.join(path, "frames/*")))

    fovx = graphics.focal2fov(focal, W)
    fovy = graphics.focal2fov(focal, H)

    def read_split(ids) -> list[CameraSample]:
        out = []
        for i in ids:
            w2c = np.linalg.inv(c2w_all[i])
            R, T = w2c[:3, :3].T, w2c[:3, 3]
            frames = sorted(os.listdir(video_paths[i]))[:num_images]
            for idx, name in enumerate(frames):
                img = Image.open(os.path.join(video_paths[i], name))
                rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
                cam = make_camera(R, T, fovx, fovy, rgb.shape[0],
                                  rgb.shape[1],
                                  time=idx / max(num_images - 1, 1),
                                  device=device)
                out.append(CameraSample(camera=cam, image=rgb, alpha=None,
                                        image_name=name))
        return out

    test_ids = list(hold_id)
    train_ids = [i for i in range(c2w_all.shape[0]) if i not in test_ids]
    train, test = read_split(train_ids), read_split(test_ids)
    if not eval_split:
        train, test = train + test, []

    rng = np.random.RandomState(seed)
    pts = (rng.random((num_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = (0.5 + 0.28209479177387814
            * rng.random((num_init_points, 3)) / 255).astype(np.float32)
    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_norm=get_nerfpp_norm(train),
                     init_points=pts, init_colors=cols)
