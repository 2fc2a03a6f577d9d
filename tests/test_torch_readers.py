"""Port parity, the scene readers other than Blender and Dynamic-360
(d2dgs_torch/data/{colmap,plenoptic,dtu,nerfies,cmu}.py): the fixtures of
tests/test_dataset_readers.py (COLMAP binary and text, the Plenoptic pose
shuffle, the DTU decomposition, CMU, an unknown layout) and a Nerfies
fixture, each written to disk and read through both packages'
``load_scene``.  Cameras, images, masks and initial points agree to 1e-6
(the cameras are built from the same float64 host maths; images are the
same PNG bytes)."""
import json
import os
import struct

import numpy as np
import pytest
import torch

from d2dgs_tpu.data import colmap as jcolmap
from d2dgs_tpu.data.dnerf import load_scene as jload
from d2dgs_tpu.data.dtu import decompose_projection as jdecompose
from d2dgs_tpu.data.plenoptic import _poses_from_bounds as jposes
from d2dgs_torch.data import colmap as tcolmap
from d2dgs_torch.data.dnerf import load_scene as tload
from d2dgs_torch.data.dtu import decompose_projection as tdecompose
from d2dgs_torch.data.plenoptic import _poses_from_bounds as tposes

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _png(path, H=8, W=8, rgba=False, value=128, seed=None):
    from PIL import Image
    c = 4 if rgba else 3
    if seed is None:
        arr = np.full((H, W, c), value, np.uint8)
    else:
        arr = np.random.RandomState(seed).randint(0, 256, (H, W, c),
                                                  dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr, "RGBA" if rgba else "RGB").save(path)


def _same_samples(ts, js):
    assert len(ts) == len(js) > 0
    for t, j in zip(ts, js):
        for f in ("w2c", "cam_center", "fx", "fy", "time"):
            np.testing.assert_allclose(getattr(t.camera, f).numpy(),
                                       np.asarray(getattr(j.camera, f)),
                                       err_msg=f, **TOL)
        assert (t.camera.H, t.camera.W) == (j.camera.H, j.camera.W)
        np.testing.assert_allclose(t.image, j.image, **TOL)
        if j.alpha is None:
            assert t.alpha is None
        else:
            np.testing.assert_allclose(t.alpha, j.alpha, **TOL)
        assert t.image_name == j.image_name


def _same_scene(root, **kw):
    j = jload(str(root), **kw)
    t = tload(str(root), device="cpu", **kw)
    _same_samples(t.train_cameras, j.train_cameras)
    if j.test_cameras:
        _same_samples(t.test_cameras, j.test_cameras)
    else:
        assert t.test_cameras == []
    np.testing.assert_allclose(t.init_points, j.init_points, **TOL)
    np.testing.assert_allclose(t.init_colors, j.init_colors, **TOL)
    np.testing.assert_allclose(t.nerf_norm["translate"],
                               j.nerf_norm["translate"], **TOL)
    assert abs(t.cameras_extent - j.cameras_extent) <= 1e-6
    return t


# --- COLMAP ------------------------------------------------------------

def _write_colmap_binary(sparse, n_imgs=4):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, 8, 8))   # PINHOLE 8x8
        fh.write(struct.pack("<4d", 10.0, 11.0, 4.0, 4.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", n_imgs))
        for i in range(n_imgs):
            q = np.array([1.0, 0.1 * i, -0.05 * i, 0.02])
            q /= np.linalg.norm(q)
            fh.write(struct.pack("<i", i + 1))
            fh.write(struct.pack("<4d", *q))
            fh.write(struct.pack("<3d", 0.1 * i, 0.0, 2.0))
            fh.write(struct.pack("<i", 1))
            fh.write(f"{i:04d}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 1))
            fh.write(struct.pack("<ddq", 1.0, 2.0, -1))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 2))
        for i in range(2):
            fh.write(struct.pack("<q", i))
            fh.write(struct.pack("<3d", i, 0.5, 0.25))
            fh.write(struct.pack("<3B", 255, 128, 0))
            fh.write(struct.pack("<d", 0.5))
            fh.write(struct.pack("<Q", 1))
            fh.write(struct.pack("<ii", 1, 0))


def test_colmap_binary_layout(tmp_path):
    _write_colmap_binary(str(tmp_path / "sparse" / "0"))
    for i in range(4):
        _png(str(tmp_path / "images" / f"{i:04d}.png"), rgba=(i % 2 == 0),
             seed=i)
    for a, b in zip(tcolmap.load_sparse_model(str(tmp_path / "sparse/0")),
                    jcolmap.load_sparse_model(str(tmp_path / "sparse/0"))):
        assert type(a) is type(b)
    t = _same_scene(tmp_path, llffhold=2)
    assert len(t.train_cameras) == 2 and len(t.test_cameras) == 2
    assert t.init_points.shape[0] == 2
    assert t.train_cameras[0].alpha is None          # an RGB image
    assert t.test_cameras[0].alpha is not None       # an RGBA one


def test_colmap_text_layout(tmp_path):
    sparse = tmp_path / "colmap_sparse" / "0"
    os.makedirs(sparse)
    (sparse / "cameras.txt").write_text(
        "# comment\n1 SIMPLE_PINHOLE 8 8 10.0 4.0 4.0\n")
    lines = []
    for i in range(3):
        lines.append(f"{i + 1} 1 0 0 0 {0.2 * i} 0 2 1 {i:04d}.png")
        lines.append("1.0 2.0 -1")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    (sparse / "points3D.txt").write_text(
        "0 1 2 3 255 0 0 0.1 1 0\n1 -1 0.5 2 0 255 10 0.2 1 0\n")
    for i in range(3):
        _png(str(tmp_path / "images" / f"{i:04d}.png"), seed=10 + i)
    cams = tcolmap.read_cameras_text(str(sparse / "cameras.txt"))
    fov = tcolmap.colmap_focal_fov(cams[1])
    assert fov == jcolmap.colmap_focal_fov(
        jcolmap.read_cameras_text(str(sparse / "cameras.txt"))[1])
    assert fov[0] == fov[1]   # a single-focal model
    t = _same_scene(tmp_path, eval_split=False)
    assert len(t.train_cameras) == 3 and t.test_cameras == []
    np.testing.assert_allclose(t.init_points[0], [1, 2, 3])


# --- Plenoptic (Neu3D) -------------------------------------------------

def _llff_rows(n):
    rows = []
    for v in range(n):
        m = np.zeros((3, 5))
        m[:, 0] = [0, -1, 0]      # down
        m[:, 1] = [1, 0, 0]       # right
        m[:, 2] = [0, 0, 1]       # back
        m[:, 3] = [0.3 * v, 0.1, 3.0]
        m[:, 4] = [8, 10, 12.0]   # H, W, focal
        rows.append(np.concatenate([m.reshape(-1), [0.5, 6.0]]))
    return np.asarray(rows)


def test_plenoptic_pose_shuffle_matches_jax():
    rows = _llff_rows(3)
    (tp, thwf), (jp, jhwf) = tposes(rows), jposes(rows)
    assert thwf == jhwf == (8, 10, 12.0)
    np.testing.assert_array_equal(tp, jp)


def test_plenoptic_layout(tmp_path):
    np.save(tmp_path / "poses_bounds.npy", _llff_rows(3))
    for v in range(3):
        for f in range(3):
            _png(str(tmp_path / "frames" / f"cam{v:02d}" / f"{f:04d}.png"),
                 H=8, W=10, seed=100 * v + f)
    t = _same_scene(tmp_path, num_images=2, num_init_points=50)
    assert len(t.train_cameras) == 4 and len(t.test_cameras) == 2


# --- DTU ---------------------------------------------------------------

def _projection(rot_z, t):
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    c, s = np.cos(rot_z), np.sin(rot_z)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    P = np.eye(4)
    P[:3] = K @ np.concatenate([R, np.asarray(t)[:, None]], axis=1)
    return P


def test_dtu_decompose_projection_matches_jax():
    P = _projection(np.pi / 2, [0.5, -0.25, 2.0])[:3]
    for a, b in zip(tdecompose(P), jdecompose(P)):
        np.testing.assert_array_equal(a, b)


def test_dtu_layout(tmp_path):
    mats = {}
    for i in range(3):
        mats[f"world_mat_{i}"] = _projection(0.3 * i, [0.1 * i, -0.2, 3.0])
        mats[f"scale_mat_{i}"] = np.diag([1.5, 1.5, 1.5, 1.0])
        mats[f"fid_{i}"] = np.asarray(i)
        _png(str(tmp_path / "image" / f"{i:03d}.png"), H=6, W=8, seed=i)
        from PIL import Image
        m = (np.random.RandomState(50 + i).rand(6, 8) > 0.5) * 255
        os.makedirs(tmp_path / "mask", exist_ok=True)
        Image.fromarray(m.astype(np.uint8)).save(
            tmp_path / "mask" / f"{i:03d}.png")
    np.savez(tmp_path / "cameras_sphere.npz", **mats)
    t = _same_scene(tmp_path, num_init_points=50)
    assert len(t.train_cameras) == 3


# --- Nerfies / HyperNeRF -----------------------------------------------

def _write_nerfies(root, ids=("a0", "a1", "a2", "a3"), points=False):
    os.makedirs(root / "camera")
    for k, im in enumerate(ids):
        ang = 0.2 * k
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]])
        (root / "camera" / f"{im}.json").write_text(json.dumps({
            "orientation": R.tolist(), "position": [0.1 * k, 0.2, -3.0],
            "focal_length": 20.0, "principal_point": [8.0, 6.0],
            "image_size": [16, 12]}))
        _png(str(root / "rgb" / "2x" / f"{im}.png"), H=6, W=8, seed=k)
    (root / "scene.json").write_text(json.dumps(
        {"scale": 0.5, "center": [0.1, 0.0, -0.2]}))
    (root / "metadata.json").write_text(json.dumps(
        {im: {"time_id": k, "warp_id": k, "camera_id": 0}
         for k, im in enumerate(ids)}))
    (root / "dataset.json").write_text(json.dumps(
        {"ids": list(ids), "train_ids": list(ids[::2]),
         "val_ids": list(ids[1::2])}))
    if points:
        np.save(root / "points.npy",
                np.random.RandomState(0).rand(20, 3).astype(np.float32))


@pytest.mark.parametrize("inter_valid,points", [(True, False),
                                                (False, True)])
def test_nerfies_layout(tmp_path, inter_valid, points):
    root = tmp_path / "misc" / "scene"
    _write_nerfies(root, points=points)
    t = _same_scene(root, inter_valid=inter_valid, num_init_points=50)
    assert len(t.train_cameras) == 4
    assert len(t.test_cameras) == (20 if inter_valid else 4)
    assert t.init_points.shape[0] == (20 if points else 50)


# --- CMU Panoptic and an unknown layout --------------------------------

def test_cmu_layout(tmp_path):
    md = {"w": 8, "h": 8,
          "k": [[[[10, 0, 4], [0, 12, 4], [0, 0, 1]]] * 2] * 2,
          "w2c": [[np.eye(4).tolist(),
                   [[0, 0, 1, 0.5], [0, 1, 0, 0], [-1, 0, 0, 2], [0, 0, 0, 1]]
                   ]] * 2,
          "fn": [["c0/0.jpg", "c1/0.jpg"], ["c0/1.jpg", "c1/1.jpg"]]}
    (tmp_path / "train_meta.json").write_text(json.dumps(md))
    for t in range(2):
        for c in range(2):
            _png(str(tmp_path / "ims" / f"c{c}" / f"{t}.jpg"), seed=t + 4 * c)
    from PIL import Image
    os.makedirs(tmp_path / "seg" / "c0")
    Image.fromarray((np.eye(8) * 255).astype(np.uint8)).save(
        tmp_path / "seg" / "c0" / "0.png")
    np.savez(tmp_path / "init_pt_cld.npz",
             data=np.random.RandomState(0).rand(16, 6).astype(np.float32))
    t = _same_scene(tmp_path)
    assert len(t.train_cameras) == 4
    np.testing.assert_allclose(t.init_points.mean(0), 0.0, atol=1e-6)


def test_unknown_layout_raises_in_both(tmp_path):
    for load in (jload, lambda p: tload(p, device="cpu")):
        with pytest.raises(ValueError, match="unrecognised"):
            load(str(tmp_path))
