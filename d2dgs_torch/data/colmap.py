"""COLMAP sparse-model parsing and scene reader (counterpart of
d2dgs_tpu/data/colmap.py: the reference's scene/colmap_loader.py, binary
and text models, colmap_loader.py:1-288, and the COLMAP branch of
scene/dataset_readers.py:124-270).  Host numpy; each sample's camera is
built on ``device``.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

from ..utils import graphics
from .cameras import make_camera

ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name"])

# COLMAP model_id -> (name, num_params). Only the undistorted-compatible
# subset the reference accepts (dataset_readers.py:143-153) plus the ids
# needed to skip over other models' params when parsing.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_NPARAMS = {v[0]: v[1] for v in CAMERA_MODELS.values()}


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(fh, "<iiQQ")
            name, npar = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{npar}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            iid = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            (cam_id,) = _read(fh, "<i")
            name = b""
            c = fh.read(1)
            while c != b"\x00":
                name += c
                c = fh.read(1)
            (npts,) = _read(fh, "<Q")
            fh.seek(24 * npts, 1)  # skip (x, y, point3D_id) triples
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return imgs


def read_points3d_binary(path: str):
    """Returns (xyz [P,3], rgb [P,3] in 0..1, error [P])."""
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        xyz = np.empty((n, 3)); rgb = np.empty((n, 3)); err = np.empty(n)
        for i in range(n):
            data = _read(fh, "<Q3d3Bd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(fh, "<Q")
            fh.seek(8 * track_len, 1)
    return xyz, rgb / 255.0, err


def _text_lines(path):
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    for line in _text_lines(path):
        el = line.split()
        cid, model = int(el[0]), el[1]
        cams[cid] = ColmapCamera(cid, model, int(el[2]), int(el[3]),
                                 np.array(el[4:], np.float64))
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    lines = list(_text_lines(path))
    for line in lines[::2]:  # every image is 2 lines: meta, then points2D
        el = line.split()
        imgs[int(el[0])] = ColmapImage(
            int(el[0]), np.array(el[1:5], np.float64),
            np.array(el[5:8], np.float64), int(el[8]), el[9])
    return imgs


def read_points3d_text(path: str):
    rows = [line.split()[:8] for line in _text_lines(path)]
    arr = np.array(rows, np.float64)
    return arr[:, 1:4], arr[:, 4:7] / 255.0, arr[:, 7]


def load_sparse_model(sparse_dir: str):
    """Load (cameras, images, points) from a COLMAP sparse/0 dir,
    preferring binary (colmap_loader semantics)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts = None
    for name, reader in (("points3D.bin", read_points3d_binary),
                         ("points3D.txt", read_points3d_text)):
        p = os.path.join(sparse_dir, name)
        if os.path.exists(p):
            pts = reader(p)
            break
    return cams, imgs, pts


def colmap_focal_fov(intr: ColmapCamera):
    """fovx/fovy per camera model (dataset_readers.py:143-153; the
    single-focal models use params[0] for both axes)."""
    if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL",
                      "SIMPLE_RADIAL_FISHEYE"):
        fx = fy = intr.params[0]
    elif intr.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE",
                        "FULL_OPENCV"):
        fx, fy = intr.params[0], intr.params[1]
    else:
        raise ValueError(
            f"unsupported COLMAP camera model {intr.model}: only "
            "undistorted pinhole-like models are handled")
    return (graphics.focal2fov(fx, intr.width),
            graphics.focal2fov(fy, intr.height))


def load_colmap_scene(path: str, images_dir: str | None = None,
                      eval_split: bool = True, llffhold: int = 16,
                      device="cuda"):
    """readColmapSceneInfo equivalent (dataset_readers.py:201-270):
    frame index parsed from the image name becomes the normalized
    timestamp; every llffhold-th frame is the test split."""
    from PIL import Image

    from .dnerf import CameraSample, SceneInfo, get_nerfpp_norm

    sparse = "sparse" if os.path.exists(os.path.join(path, "sparse")) \
        else "colmap_sparse"
    cams, imgs, pts = load_sparse_model(os.path.join(path, sparse, "0"))

    reading_dir = os.path.join(path, images_dir or "images")
    n_frames = len(imgs)
    samples = []
    for key in sorted(imgs, key=lambda k: imgs[k].name):
        extr = imgs[key]
        intr = cams[extr.camera_id]
        # reference convention: R = c2w rotation, T = w2c translation
        R = qvec_to_rotmat(extr.qvec).T
        T = np.asarray(extr.tvec)
        fovx, fovy = colmap_focal_fov(intr)
        stem = os.path.basename(extr.name).split(".")[0]
        fid = int(stem) / max(n_frames - 1, 1)

        img = Image.open(os.path.join(reading_dir,
                                      os.path.basename(extr.name)))
        data = np.asarray(img.convert("RGBA"), np.float32) / 255.0
        alpha = data[..., 3:4] if img.mode in ("RGBA", "LA") else None
        cam = make_camera(R, T, fovx, fovy, intr.height, intr.width,
                          time=fid, device=device)
        samples.append(CameraSample(camera=cam, image=data[..., :3],
                                    alpha=alpha,
                                    image_name=os.path.basename(extr.name)))

    if eval_split:
        train = [s for i, s in enumerate(samples) if i % llffhold != 0]
        test = [s for i, s in enumerate(samples) if i % llffhold == 0]
    else:
        train, test = samples, []

    if pts is not None:
        xyz, rgb = pts[0].astype(np.float32), pts[1].astype(np.float32)
    else:  # no sparse points: random cloud like the synthetic path
        rng = np.random.RandomState(0)
        xyz = (rng.random((100_000, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = np.full((100_000, 3), 0.5, np.float32)

    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_norm=get_nerfpp_norm(train or test),
                     init_points=xyz, init_colors=rgb)
