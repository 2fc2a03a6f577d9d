"""DTU (NeuS-style cameras_sphere.npz) dataset reader (counterpart of
d2dgs_tpu/data/dtu.py: readDTUCameras / readNeuSDTUInfo,
scene/dataset_readers.py:405-491, with load_K_Rt_from_P's projection
decomposition, dataset_readers.py:57-77, by an RQ factorization instead
of cv2).  Cameras are built on ``device``.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..utils import graphics
from .cameras import make_camera
from .dnerf import CameraSample, SceneInfo, get_nerfpp_norm


def decompose_projection(P: np.ndarray):
    """P[3,4] = K [R | t] -> (K normalized, pose c2w[4,4]).
    Matches cv2.decomposeProjectionMatrix semantics used by the
    reference's load_K_Rt_from_P."""
    from scipy.linalg import rq

    K, R = rq(P[:3, :3])
    # make K's diagonal positive (absorb signs into R)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    t = np.linalg.solve(K, P[:3, 3])
    cam_center = -R.T @ t
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T          # c2w rotation
    pose[:3, 3] = cam_center
    return K, pose


def _dtu_pose_munge(pose: np.ndarray) -> np.ndarray:
    """The reference's axis gymnastics on the NeuS pose
    (dataset_readers.py:425-444): two row swaps with sign flips, a
    similarity flip of y/z, and a 0.5 world scale."""
    pose = np.concatenate([pose[0:1], -pose[2:3], -pose[1:2], pose[3:]], 0)
    S = np.diag([1.0, -1.0, -1.0])
    pose[1, 3] = -pose[1, 3]
    pose[2, 3] = -pose[2, 3]
    pose[:3, :3] = S @ pose[:3, :3] @ S
    pose = np.concatenate([pose[0:1], pose[2:3], pose[1:2], pose[3:]], 0)
    pose[:, 3] *= 0.5
    return pose


def load_dtu_scene(path: str, render_camera: str = "cameras_sphere.npz",
                   num_init_points: int = 100_000,
                   seed: int = 0, device="cuda") -> SceneInfo:
    from PIL import Image

    camera_dict = np.load(os.path.join(path, render_camera))
    images = sorted(glob.glob(os.path.join(path, "image/*.png")))
    masks = sorted(glob.glob(os.path.join(path, "mask/*.png")))
    n = len(images)

    samples = []
    for idx in range(n):
        img = np.asarray(Image.open(images[idx]), np.float32) / 255.0
        mask = np.asarray(Image.open(masks[idx]), np.float32) / 255.0
        if mask.ndim == 2:
            mask = mask[..., None]
        rgb = img[..., :3] * mask[..., :1]

        world_mat = camera_dict[f"world_mat_{idx}"].astype(np.float32)
        scale_mat = camera_dict[f"scale_mat_{idx}"].astype(np.float32)
        fid = float(camera_dict[f"fid_{idx}"]) / max(n / 12 - 1, 1)
        P = (world_mat @ scale_mat)[:3, :4]
        K, pose = decompose_projection(P)
        pose = _dtu_pose_munge(pose)

        # reference's (R, T) extraction with the blender-style sign flips
        m = np.linalg.inv(pose)
        R = -m[:3, :3].T
        R[:, 0] = -R[:, 0]
        T = -m[:3, 3]

        H, W = rgb.shape[:2]
        fov = graphics.focal2fov(K[0, 0], W)
        fovy = graphics.focal2fov(K[0, 0], H)
        cam = make_camera(R, T, fov, fovy, H, W, time=fid, device=device)
        samples.append(CameraSample(camera=cam, image=rgb,
                                    alpha=mask[..., :1],
                                    image_name=os.path.basename(
                                        images[idx])))

    rng = np.random.RandomState(seed)
    pts = (rng.random((num_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = (0.5 + 0.28209479177387814
            * rng.random((num_init_points, 3)) / 255).astype(np.float32)
    return SceneInfo(train_cameras=samples, test_cameras=[],
                     nerf_norm=get_nerfpp_norm(samples),
                     init_points=pts, init_colors=cols)
