"""CMU Panoptic dataset reader (counterpart of d2dgs_tpu/data/cmu.py:
readCMUInfo / readCMUSceneInfo, scene/dataset_readers.py:864-947):
{split}_meta.json holding per-(t, cam) intrinsics k and extrinsics w2c,
images under ims/, optional segmentation masks under seg/, the init
cloud from init_pt_cld.npz, point-cloud recentring.  Cameras are built
on ``device``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from .cameras import make_camera
from .dnerf import CameraSample, SceneInfo, get_nerfpp_norm
from ..utils.sh import C0


def _sh2rgb(sh: np.ndarray) -> np.ndarray:
    return sh * C0 + 0.5


def _read_split(path: str, split: str, num_timesteps: int = 20,
                time_denom: float = 150.0,
                device="cuda") -> list[CameraSample]:
    from PIL import Image

    with open(os.path.join(path, f"{split}_meta.json")) as fh:
        md = json.load(fh)
    samples = []
    T_steps = min(num_timesteps, len(md["fn"]))
    for t in range(T_steps):
        for c in range(len(md["fn"][t])):
            w, h = md["w"], md["h"]
            k = np.asarray(md["k"][t][c], np.float64)
            w2c = np.asarray(md["w2c"][t][c], np.float64)
            name = md["fn"][t][c]

            img = Image.open(os.path.join(path, "ims", name))
            rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
            seg_path = os.path.join(path, "seg",
                                    name.replace(".jpg", ".png"))
            alpha = None
            if os.path.exists(seg_path):
                seg = np.asarray(Image.open(seg_path), np.float32)
                alpha = (seg[..., None] if seg.ndim == 2
                         else seg[..., :1])
                alpha = np.clip(alpha, 0.0, 1.0)

            fx, fy = k[0][0], k[1][1]
            fovx = 2 * math.atan(w / (2 * fx))
            fovy = 2 * math.atan(h / (2 * fy))
            # reference transposes w2c then takes (R, T) in its c2w-R
            # convention (dataset_readers.py:885-899)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            cam = make_camera(R, T, fovx, fovy, h, w,
                              time=t / time_denom, device=device)
            samples.append(CameraSample(camera=cam, image=rgb, alpha=alpha,
                                        image_name=name))
    return samples


def load_cmu_scene(path: str, recenter_by_pcl: bool = True,
                   num_timesteps: int = 20, device="cuda") -> SceneInfo:
    train = _read_split(path, "train", num_timesteps, device=device)
    test = (_read_split(path, "test", num_timesteps, device=device)
            if os.path.exists(os.path.join(path, "test_meta.json")) else [])

    init = np.load(os.path.join(path, "init_pt_cld.npz"))["data"]
    xyz = init[:, :3].astype(np.float32)
    cols = _sh2rgb(init[:, 3:6]).astype(np.float32)

    if recenter_by_pcl:
        center = xyz.mean(axis=0)
        xyz = xyz - center

        def shift(s: CameraSample) -> CameraSample:
            c2w = np.linalg.inv(s.camera.w2c.cpu().numpy())
            c2w[:3, 3] -= center
            new_w2c = np.linalg.inv(c2w)
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                            device=s.camera.device)
            cam = dataclasses.replace(s.camera, w2c=f32(new_w2c),
                                      cam_center=f32(c2w[:3, 3]))
            return dataclasses.replace(s, camera=cam)

        train = [shift(s) for s in train]
        test = [shift(s) for s in test]

    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_norm=get_nerfpp_norm(train),
                     init_points=xyz, init_colors=np.clip(cols, 0, 1))
