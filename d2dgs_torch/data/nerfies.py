"""Nerfies / HyperNeRF dataset reader (counterpart of
d2dgs_tpu/data/nerfies.py: readNerfiesCameras / readNerfiesInfo,
scene/dataset_readers.py:517-775, and camera_nerfies_from_JSON,
utils/camera_utils.py:92-112): scene.json centre/scale normalization,
per-image camera JSONs, time ids from metadata.json, split selection by
scene-name prefix, and optional slerp view-synthesized validation
cameras.  Cameras are built on ``device``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils import graphics
from .cameras import make_camera
from .dnerf import CameraSample, SceneInfo, get_nerfpp_norm


def load_nerfies_camera(path: str, scale: float) -> dict:
    """One camera/*.json file -> dict (utils/camera_utils.py:92-112)."""
    with open(path) as fh:
        cj = json.load(fh)
    return dict(
        orientation=np.array(cj["orientation"]),
        position=np.array(cj["position"]),
        focal_length=cj["focal_length"] * scale,
        principal_point=np.array(cj["principal_point"]) * scale,
        image_size=np.array(
            [int(round(cj["image_size"][0] * scale)),
             int(round(cj["image_size"][1] * scale))]),
    )


def view_synthesis(poses: np.ndarray, factor: int = 5) -> np.ndarray:
    """Slerp + lerp a denser [K,4,4] pose trajectory from [F,4,4]
    (dataset_readers.py:494-515)."""
    from scipy.interpolate import interp1d
    from scipy.spatial.transform import Rotation, Slerp

    frame_num = poses.shape[0]
    slerp = Slerp(np.arange(frame_num),
                  Rotation.from_matrix(poses[:, :3, :3]))
    f_tran = interp1d(np.arange(frame_num), poses[:, :3, 3].T)
    new_num = int(frame_num * factor)
    ts = np.linspace(0, frame_num - 1, new_num)
    out = np.zeros((new_num, 4, 4))
    out[:, :3, :3] = slerp(ts).as_matrix()
    out[:, :3, 3] = f_tran(ts).T
    out[:, 3, 3] = 1.0
    return out


def _split_ids(scene_name: str, dataset_json: dict):
    """Train/val id selection + resolution ratio by scene-name prefix
    (dataset_readers.py:528-549)."""
    if scene_name.startswith("vrig"):
        return dataset_json["train_ids"], dataset_json["val_ids"], 0.25
    if scene_name.startswith("NeRF"):
        return dataset_json["train_ids"], dataset_json["val_ids"], 1.0
    if scene_name.startswith("interp"):
        ids = dataset_json["ids"]
        return ([x for i, x in enumerate(ids) if i % 4 == 0],
                [x for i, x in enumerate(ids) if i % 4 == 2], 0.5)
    # hypernerf misc scenes
    return dataset_json["ids"], dataset_json["ids"][:4], 0.5


def load_nerfies_scene(path: str, eval_split: bool = True,
                       inter_valid: bool = True,
                       num_init_points: int = 100_000,
                       seed: int = 0, device="cuda") -> SceneInfo:
    from PIL import Image

    with open(os.path.join(path, "scene.json")) as fh:
        scene_json = json.load(fh)
    with open(os.path.join(path, "metadata.json")) as fh:
        meta = json.load(fh)
    with open(os.path.join(path, "dataset.json")) as fh:
        dataset_json = json.load(fh)

    coord_scale = scene_json["scale"]
    scene_center = np.asarray(scene_json["center"])
    scene_name = os.path.basename(os.path.dirname(path.rstrip("/")))
    train_ids, val_ids, ratio = _split_ids(scene_name, dataset_json)
    all_ids = list(train_ids) + list(val_ids)

    max_time = max(meta[i]["time_id"] for i in all_ids)
    times = [meta[i]["time_id"] / max(max_time, 1) for i in all_ids]

    rgba_dir = os.path.join(path, "rgb", "rgba")
    use_rgba = os.path.exists(rgba_dir)
    msk_dir = os.path.join(path, "resized_mask", f"{int(1 / ratio)}x")
    use_mask = (not use_rgba) and os.path.exists(msk_dir)

    def read_sample(im_id: str, fid: float) -> CameraSample:
        cam_p = load_nerfies_camera(
            os.path.join(path, "camera", f"{im_id}.json"), ratio)
        position = (cam_p["position"] - scene_center) * coord_scale
        # w2c rotation rows = orientation; reference stores R as c2w
        R = cam_p["orientation"].T
        T = -position @ cam_p["orientation"].T
        if use_rgba:
            img_path = os.path.join(rgba_dir, f"{im_id}.png")
        else:
            img_path = os.path.join(path, "rgb", f"{int(1 / ratio)}x",
                                    f"{im_id}.png")
        img = Image.open(img_path)
        data = np.asarray(img.convert("RGBA"), np.float32) / 255.0
        rgb = data[..., :3]
        alpha = data[..., 3:4] if img.mode == "RGBA" else None
        if use_mask:
            m = np.asarray(Image.open(
                os.path.join(msk_dir, f"{im_id}.png.png")), np.float32)
            alpha = (1.0 - m[..., :1] / 255.0
                     if m.ndim == 3 else 1.0 - m[..., None] / 255.0)
        H, W = rgb.shape[:2]
        focal = cam_p["focal_length"]
        cam = make_camera(R, T, graphics.focal2fov(focal, W),
                          graphics.focal2fov(focal, H), H, W, time=fid,
                          device=device)
        return CameraSample(camera=cam, image=rgb, alpha=alpha,
                            image_name=str(im_id))

    train = [read_sample(i, t)
             for i, t in zip(all_ids[:len(train_ids)], times)]

    if inter_valid and train:
        # validation cameras synthesized along the slerped train
        # trajectory (dataset_readers.py:577-613)
        poses = np.stack([s.camera.w2c.cpu().numpy() for s in train])
        synth = view_synthesis(poses, factor=5)
        fids = np.linspace(0, 1, synth.shape[0])
        last = train[-1]
        test = []
        for k in range(synth.shape[0]):
            m = synth[k]
            R, T = m[:3, :3].T, m[:3, 3]
            cam = make_camera(
                R, T,
                2 * np.arctan(last.camera.W / (2 * float(last.camera.fx))),
                2 * np.arctan(last.camera.H / (2 * float(last.camera.fy))),
                last.camera.H, last.camera.W, time=float(fids[k]),
                device=device)
            test.append(CameraSample(camera=cam, image=last.image,
                                     alpha=last.alpha,
                                     image_name=f"synth_{k}"))
    else:
        test = [read_sample(i, t)
                for i, t in zip(all_ids[len(train_ids):],
                                times[len(train_ids):])]
    if not eval_split:
        train, test = train + test, []

    # init cloud: points.npy if present (nerfies exports), else random
    pts_path = os.path.join(path, "points.npy")
    if os.path.exists(pts_path):
        xyz = ((np.load(pts_path) - scene_center) * coord_scale)
        rng = np.random.RandomState(seed)
        cols = rng.random(xyz.shape).astype(np.float32)
    else:
        rng = np.random.RandomState(seed)
        xyz = rng.random((num_init_points, 3)) * 2.6 - 1.3
        cols = rng.random((num_init_points, 3)).astype(np.float32)

    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_norm=get_nerfpp_norm(train),
                     init_points=xyz.astype(np.float32),
                     init_colors=cols.astype(np.float32))
