"""Phone-capture preprocessing (reference data_tools/phone_catch.py):
video -> frames -> blur filtering -> RGBA masking -> COLMAP/NeRF
conversion, as plain-numpy/PIL utilities.

The reference's interactive segmentation (MiVOS) is GPU+GUI-bound and is
NOT reproduced here; `mask_images` consumes any precomputed mask folder
(e.g. from rembg, SAM, or manual tooling) instead.  ffmpeg replaces
cv2.VideoCapture for frame extraction.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys

import numpy as np


def _laplacian_var(path: str) -> float:
    from PIL import Image
    img = np.asarray(Image.open(path).convert("L"), np.float32)
    lap = (-4.0 * img[1:-1, 1:-1] + img[:-2, 1:-1] + img[2:, 1:-1]
           + img[1:-1, :-2] + img[1:-1, 2:])
    return float(lap.var())


def cal_ambiguity(path: str):
    """Per-frame Laplacian sharpness (phone_catch.py:29-48)."""
    imgs = sorted(glob.glob(os.path.join(path, "*.png")))
    laplace = np.array([_laplacian_var(p) for p in imgs], np.float32)
    return laplace, dict(zip(imgs, laplace))


def select_ambiguity(path: str, nb: int = 10, threshold: float = 0.8,
                     mv_files: bool = False):
    """Flag frames whose sharpness dips below `threshold` x a local
    linear fit of the sharpness curve (phone_catch.py:51-77); optionally
    move them into ../noise/."""
    laplace, lap_dict = cal_ambiguity(path)
    imgs = list(lap_dict.keys())
    amb_img, amb_lap = [], []
    noise_dir = os.path.join(path, "..", "noise")
    for i in range(len(laplace)):
        i1, i2 = max(0, i - nb // 2), min(len(laplace), i + nb // 2)
        xs = np.arange(i1, i2, dtype=np.float32)
        ys = laplace[i1:i2]
        a, b = np.polyfit(xs, ys, 1) if len(xs) > 1 else (0.0, ys[0])
        pred = a * i + b
        if pred > 0 and laplace[i] / pred < threshold:
            amb_img.append(imgs[i])
            amb_lap.append(float(laplace[i]))
            if mv_files:
                os.makedirs(noise_dir, exist_ok=True)
                shutil.move(imgs[i], os.path.join(
                    noise_dir, os.path.basename(imgs[i])))
    return amb_img, amb_lap


def mask_images(img_path: str, msk_path: str, sv_path: str | None = None,
                no_mask: bool = False) -> str:
    """Attach per-frame masks as the alpha channel
    (phone_catch.py:80-107): image dirs in, masked_images/ out."""
    from PIL import Image
    names = sorted(f for f in os.listdir(img_path)
                   if f.endswith((".png", ".jpg")))
    if sv_path is None:
        sv_path = os.path.join(os.path.dirname(img_path.rstrip("/")),
                               "masked_images")
    os.makedirs(sv_path, exist_ok=True)
    for name in names:
        image = np.asarray(Image.open(os.path.join(img_path, name)))
        if no_mask:
            mask = np.full(image.shape[:2], 255, np.uint8)
        else:
            m = Image.open(os.path.join(msk_path, name)).convert("L")
            m = m.resize((image.shape[1], image.shape[0]))
            mask = np.asarray(m)
            if mask.max() == 1:
                mask = mask * 255
        rgba = np.concatenate([image[..., :3], mask[..., None]], axis=-1)
        Image.fromarray(rgba).save(os.path.join(sv_path, name))
    return sv_path


def extract_frames_mp4(path: str, gap: int | None = None,
                       frame_num: int = 300,
                       sv_path: str | None = None) -> str:
    """Video -> numbered PNG frames via ffmpeg (phone_catch.py:110-135).
    `gap` selects every gap-th frame; default targets ~frame_num total."""
    if sv_path is None:
        sv_path = os.path.join(os.path.dirname(path), "images")
    if os.path.exists(sv_path) and os.listdir(sv_path):
        return sv_path
    os.makedirs(sv_path, exist_ok=True)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    vf = []
    if gap is not None:
        vf = ["-vf", f"select=not(mod(n\\,{gap}))", "-vsync", "vfr"]
    else:
        # probe duration*fps to derive the gap
        try:
            probe = subprocess.run(
                ["ffprobe", "-v", "error", "-count_packets",
                 "-select_streams", "v:0", "-show_entries",
                 "stream=nb_read_packets", "-of", "csv=p=0", path],
                capture_output=True, text=True)
            total = int(probe.stdout.strip() or 0)
            g = max(total // frame_num, 1)
            vf = ["-vf", f"select=not(mod(n\\,{g}))", "-vsync", "vfr"]
        except (FileNotFoundError, ValueError):
            pass
    cmd = ["ffmpeg", "-y", "-i", path, *vf,
           os.path.join(sv_path, "%05d.png")]
    print("+ " + " ".join(cmd), flush=True)
    try:
        if subprocess.run(cmd).returncode != 0:
            sys.exit("error: ffmpeg failed")
    except FileNotFoundError:
        sys.exit("error: `ffmpeg` binary not found")
    return sv_path


def rename_images(path: str) -> None:
    names = sorted(f for f in os.listdir(path)
                   if f.endswith((".png", ".jpg")))
    for i, name in enumerate(names):
        shutil.move(os.path.join(path, name),
                    os.path.join(path, "%05d.png" % i))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser("phone_catch")
    p.add_argument("--video", help="input mp4 to extract frames from")
    p.add_argument("--images", help="frames dir (extracted or existing)")
    p.add_argument("--masks", help="precomputed mask dir -> RGBA alpha")
    p.add_argument("--no_mask", action="store_true")
    p.add_argument("--filter_blur", action="store_true",
                   help="move blurry frames to ../noise")
    p.add_argument("--colmap", action="store_true",
                   help="run colmap2nerf on the (masked) images")
    a = p.parse_args(argv)
    images = a.images
    if a.video:
        images = extract_frames_mp4(a.video, sv_path=a.images)
    if a.filter_blur and images:
        amb, _ = select_ambiguity(images, mv_files=True)
        print(f"moved {len(amb)} blurry frames to ../noise")
    if images and (a.masks or a.no_mask):
        images = mask_images(images, a.masks, no_mask=a.no_mask)
    if a.colmap and images:
        from .colmap2nerf import colmap2nerf_invoke
        colmap2nerf_invoke(images)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
