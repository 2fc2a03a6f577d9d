"""D-NeRF / Blender dataset reader (counterpart of d2dgs_tpu/data/dnerf.py,
the reference's scene/dataset_readers.py:272-391 and the sniffing of
scene/__init__.py:45-66).

Images stay numpy on the host; each sample's camera is built on
``device`` (``cuda`` unless the caller asks for another).  This module
reads the Blender (``transforms_train.json``) and Dynamic-360
(``transforms.json``) layouts; ``load_scene`` hands COLMAP, DTU,
Nerfies/HyperNeRF, Plenoptic and CMU Panoptic layouts to their readers.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..utils import graphics
from .cameras import Camera, make_camera


@dataclasses.dataclass
class CameraSample:
    """One (camera, frame) training sample."""
    camera: Camera
    image: np.ndarray            # [H,W,3] float32 in [0,1], NOT composited
    alpha: np.ndarray | None     # [H,W,1] float32 mask (None if RGB input)
    image_name: str = ""

    def gt(self, bg: np.ndarray) -> np.ndarray:
        """Ground truth for the loss: mask-composited onto bg (the
        reference's `gt_alpha_mask_as_scene_mask`, train_gui.py:303-309)."""
        if self.alpha is None:
            return self.image
        return self.image * self.alpha + bg * (1.0 - self.alpha)


@dataclasses.dataclass
class SceneInfo:
    train_cameras: list
    test_cameras: list
    nerf_norm: dict               # {"translate": [3], "radius": float}
    init_points: np.ndarray       # [P,3]
    init_colors: np.ndarray       # [P,3]

    @property
    def cameras_extent(self) -> float:
        return float(self.nerf_norm["radius"])


def _blender_Rt(transform_matrix: np.ndarray):
    """c2w (OpenGL, y-up/z-back) -> the reference's (R, T) convention
    (dataset_readers.py:293-296: R stored as the c2w rotation with the
    y/z axis flip folded in)."""
    matrix = np.linalg.inv(np.asarray(transform_matrix, np.float64))
    R = -np.transpose(matrix[:3, :3])
    R[:, 0] = -R[:, 0]
    T = -matrix[:3, 3]
    return R, T


def read_transforms(path: str, transformsfile: str,
                    extension: str = ".png",
                    device="cuda") -> list[CameraSample]:
    """Parse one transforms_*.json (dataset_readers.py:272-325).  Frames
    are sorted by the trailing integer of their file name; `time` comes
    from the json or the frame index."""
    from PIL import Image

    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    frames = sorted(
        contents["frames"],
        key=lambda x: int(
            os.path.basename(x["file_path"]).split(".")[0].split("_")[-1]))

    out = []
    for idx, frame in enumerate(frames):
        fp = frame["file_path"]
        if not (fp.endswith(".jpg") or fp.endswith(".png")):
            fp = fp + extension
        t = frame["time"] if "time" in frame else idx / len(frames)
        R, T = _blender_Rt(frame["transform_matrix"])

        img = Image.open(os.path.join(path, fp))
        data = np.asarray(img.convert("RGBA"), np.float32) / 255.0
        rgb, alpha = data[..., :3], data[..., 3:4]
        H, W = rgb.shape[:2]
        fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
        # the reference swaps FovX/FovY for blender scenes
        # (dataset_readers.py:320-322); W == H for D-NeRF, so the natural
        # assignment is kept, as in the JAX package
        cam = make_camera(R, T, fovx, fovy, H, W, time=float(t),
                          device=device)
        out.append(CameraSample(camera=cam, image=rgb, alpha=alpha,
                                image_name=os.path.basename(fp)))
    return out


def get_nerfpp_norm(samples: list[CameraSample]) -> dict:
    """Camera-ring normalization (dataset_readers.py:79-113, apply=False)."""
    centers = np.stack([s.camera.cam_center.cpu().numpy() for s in samples])
    center = centers.mean(axis=0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=-1)))
    return {"translate": -center, "radius": radius}


def _random_cloud(num_init_points: int, seed: int):
    """Points uniform in [-1.3, 1.3]^3 and near-grey colours
    (dataset_readers.py:383-390), from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    pts = rng.random((num_init_points, 3)) * 2.6 - 1.3
    # SH2RGB(random/255) ~ 0.5 + tiny noise
    cols = 0.5 + 0.28209479177387814 * rng.random((num_init_points, 3)) / 255
    return pts.astype(np.float32), cols.astype(np.float32)


def load_blender_scene(path: str, eval_split: bool = True,
                       extension: str = ".png",
                       num_init_points: int = 100_000,
                       seed: int = 0, device="cuda") -> SceneInfo:
    """readNerfSyntheticInfo (dataset_readers.py:328-391): the train and
    test samples and a random init cloud in the Blender bounds."""
    train = read_transforms(path, "transforms_train.json", extension,
                            device=device)
    test_file = os.path.join(path, "transforms_test.json")
    test = (read_transforms(path, "transforms_test.json", extension,
                            device=device)
            if os.path.exists(test_file) else [])
    if not eval_split:
        train = train + test
    pts, cols = _random_cloud(num_init_points, seed)
    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_norm=get_nerfpp_norm(train),
                     init_points=pts, init_colors=cols)


def load_scene(path: str, device="cuda", **kw) -> SceneInfo:
    """Dataset-type sniffing by sentinel file, in the JAX package's order
    (scene/__init__.py:45-66).  All readers share the SceneInfo contract
    and build their cameras on ``device``."""
    exists = lambda *p: os.path.exists(os.path.join(path, *p))  # noqa: E731
    if exists("sparse") or exists("colmap_sparse"):
        from .colmap import load_colmap_scene
        return load_colmap_scene(path, device=device, **kw)
    if exists("transforms_train.json"):
        return load_blender_scene(path, device=device, **kw)
    if exists("cameras_sphere.npz"):
        from .dtu import load_dtu_scene
        return load_dtu_scene(path, device=device, **kw)
    if exists("dataset.json"):
        from .nerfies import load_nerfies_scene
        return load_nerfies_scene(path, device=device, **kw)
    if exists("poses_bounds.npy"):
        from .plenoptic import load_plenoptic_scene
        return load_plenoptic_scene(path, device=device, **kw)
    if exists("transforms.json"):  # Dynamic-360 (one transforms file)
        train = read_transforms(path, "transforms.json", device=device)
        pts, cols = _random_cloud(kw.get("num_init_points", 100_000),
                                  kw.get("seed", 0))
        return SceneInfo(train_cameras=train, test_cameras=[],
                         nerf_norm=get_nerfpp_norm(train),
                         init_points=pts, init_colors=cols)
    if exists("train_meta.json"):
        from .cmu import load_cmu_scene
        return load_cmu_scene(path, device=device, **kw)
    raise ValueError(f"unrecognised dataset layout at {path}")
