"""COLMAP text model -> NeRF transforms.json converter (reference
data_tools/colmap2nerf.py:145-312, itself from instant-ngp).

Reads `colmap_text/{cameras.txt, images.txt}` (COLMAP text export),
builds per-frame c2w matrices in the NeRF convention (y/z flip, y<->z
swap, world flip), reorients the average up vector to +z, recenters on
the mutual point of attention, rescales to "nerf size" (avg camera
distance 4), and writes transforms.json with camera intrinsics +
per-frame sharpness scores.

Usage:
  python -m d2dgs_torch.tools.colmap2nerf --images <dir> [--run_colmap]
  (or import colmap2nerf_invoke(img_path))
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np


def sharpness(image_path: str) -> float:
    """Variance of the Laplacian (colmap2nerf.py:96-103) via PIL+numpy."""
    from PIL import Image
    img = np.asarray(Image.open(image_path).convert("L"), np.float32)
    lap = (-4.0 * img[1:-1, 1:-1] + img[:-2, 1:-1] + img[2:, 1:-1]
           + img[1:-1, :-2] + img[1:-1, 2:])
    return float(lap.var())


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat(a, b):
    """Rotation taking unit vector a to unit vector b."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    s = np.linalg.norm(v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * ((1 - c) / (s ** 2))


def closest_point_2_lines(oa, da, ob, db):
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    if ta > 0:
        ta = 0
    if tb > 0:
        tb = 0
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def _parse_camera_line(els):
    w, h = float(els[2]), float(els[3])
    fl_x = fl_y = float(els[4])
    k1 = k2 = p1 = p2 = 0.0
    cx, cy = w / 2, h / 2
    model = els[1]
    if model == "SIMPLE_RADIAL":
        cx, cy, k1 = float(els[5]), float(els[6]), float(els[7])
    elif model == "RADIAL":
        cx, cy = float(els[5]), float(els[6])
        k1, k2 = float(els[7]), float(els[8])
    elif model == "OPENCV":
        fl_y = float(els[5])
        cx, cy = float(els[6]), float(els[7])
        k1, k2 = float(els[8]), float(els[9])
        p1, p2 = float(els[10]), float(els[11])
    elif model not in ("SIMPLE_PINHOLE", "PINHOLE"):
        print(f"unknown camera model {model}", file=sys.stderr)
    if model == "PINHOLE":
        fl_y = float(els[5])
        cx, cy = float(els[6]), float(els[7])
    return w, h, fl_x, fl_y, cx, cy, k1, k2, p1, p2


def run_colmap_text(images: str, text_folder: str, db_path: str,
                    matcher: str = "exhaustive") -> None:
    """feature_extractor -> matcher -> mapper -> model_converter(TXT)."""
    sparse = os.path.join(os.path.dirname(text_folder), "colmap_sparse")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text_folder, exist_ok=True)
    cmds = [
        ["colmap", "feature_extractor", "--ImageReader.camera_model",
         "OPENCV", "--ImageReader.single_camera", "1",
         "--database_path", db_path, "--image_path", images],
        ["colmap", f"{matcher}_matcher", "--database_path", db_path],
        ["colmap", "mapper", "--database_path", db_path, "--image_path",
         images, "--output_path", sparse],
        ["colmap", "bundle_adjuster", "--input_path",
         os.path.join(sparse, "0"), "--output_path",
         os.path.join(sparse, "0"),
         "--BundleAdjustment.refine_principal_point", "1"],
        ["colmap", "model_converter", "--input_path",
         os.path.join(sparse, "0"), "--output_path", text_folder,
         "--output_type", "TXT"],
    ]
    for cmd in cmds:
        print("+ " + " ".join(cmd), flush=True)
        try:
            if subprocess.run(cmd).returncode != 0:
                sys.exit(f"error: {cmd[1]} failed")
        except FileNotFoundError:
            sys.exit("error: `colmap` binary not found")


def colmap2nerf_invoke(img_path: str, aabb_scale: int = 16,
                       run_colmap: bool = True,
                       skip_early: int = 0) -> str | None:
    img_path = img_path.rstrip("/")
    sv_path = os.path.dirname(img_path)
    text_folder = os.path.join(sv_path, "colmap_text")
    out_path = os.path.join(sv_path, "transforms.json")
    if os.path.exists(out_path):
        return out_path
    if run_colmap and not os.path.exists(
            os.path.join(text_folder, "cameras.txt")):
        run_colmap_text(img_path, text_folder,
                        os.path.join(sv_path, "colmap.db"))

    with open(os.path.join(text_folder, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            (w, h, fl_x, fl_y, cx, cy,
             k1, k2, p1, p2) = _parse_camera_line(line.split(" "))
    angle_x = math.atan(w / (fl_x * 2)) * 2
    angle_y = math.atan(h / (fl_y * 2)) * 2

    out = {"camera_angle_x": angle_x, "camera_angle_y": angle_y,
           "fl_x": fl_x, "fl_y": fl_y, "k1": k1, "k2": k2, "p1": p1,
           "p2": p2, "cx": cx, "cy": cy, "w": w, "h": h,
           "aabb_scale": aabb_scale, "frames": []}
    bottom = np.array([[0, 0, 0, 1.0]])
    up = np.zeros(3)
    i = 0
    with open(os.path.join(text_folder, "images.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            i += 1
            if i < skip_early * 2 or i % 2 == 0:
                continue
            els = line.split(" ")
            filename = els[9].split("/")[-1]
            qvec = np.array(list(map(float, els[1:5])))
            tvec = np.array(list(map(float, els[5:8])))
            R = qvec2rotmat(-qvec)
            m = np.concatenate([np.concatenate(
                [R, tvec.reshape(3, 1)], 1), bottom], 0)
            c2w = np.linalg.inv(m)
            c2w[0:3, 2] *= -1
            c2w[0:3, 1] *= -1
            c2w = c2w[[1, 0, 2, 3], :]
            c2w[2, :] *= -1
            up += c2w[0:3, 1]
            try:
                b = sharpness(os.path.join(img_path, filename))
            except OSError:
                b = 0.0
            out["frames"].append({"file_path": f"./images/{filename}",
                                  "sharpness": b,
                                  "transform_matrix": c2w})

    nframes = len(out["frames"])
    up = up / np.linalg.norm(up)
    R = np.pad(rotmat(up, [0, 0, 1]), [0, 1])
    R[-1, -1] = 1
    for fr in out["frames"]:
        fr["transform_matrix"] = R @ fr["transform_matrix"]

    totw, totp = 0.0, np.zeros(3)
    for fr in out["frames"]:
        mf = fr["transform_matrix"][0:3, :]
        for g in out["frames"]:
            mg = g["transform_matrix"][0:3, :]
            p, wgt = closest_point_2_lines(mf[:, 3], mf[:, 2],
                                           mg[:, 3], mg[:, 2])
            if wgt > 0.01:
                totp += p * wgt
                totw += wgt
    if totw > 0:
        totp /= totw
    for fr in out["frames"]:
        fr["transform_matrix"][0:3, 3] -= totp
    avglen = float(np.mean(
        [np.linalg.norm(fr["transform_matrix"][0:3, 3])
         for fr in out["frames"]])) or 1.0
    for fr in out["frames"]:
        fr["transform_matrix"][0:3, 3] *= 4.0 / avglen
        fr["transform_matrix"] = fr["transform_matrix"].tolist()
    print(f"{nframes} frames -> {out_path}")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser("colmap2nerf")
    p.add_argument("--images", required=True)
    p.add_argument("--aabb_scale", type=int, default=16)
    p.add_argument("--skip_early", type=int, default=0)
    p.add_argument("--run_colmap", action="store_true")
    a = p.parse_args(argv)
    colmap2nerf_invoke(a.images, a.aabb_scale, a.run_colmap, a.skip_early)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
