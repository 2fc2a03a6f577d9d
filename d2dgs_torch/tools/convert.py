"""COLMAP pipeline driver (reference convert.py:1-97, itself based on
the MipNeRF-360 converter): feature extraction -> exhaustive matching ->
mapper -> image undistortion, leaving the model in the layout the COLMAP
dataset reader expects (sparse/0 + images/).  Optional multi-scale
resize is done with PIL (the reference shells out to ImageMagick).

Usage: python -m d2dgs_torch.tools.convert -s <source_path> [--no_gpu]
       [--skip_matching] [--camera OPENCV] [--resize]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _run(cmd: list[str]) -> None:
    print("+ " + " ".join(cmd), flush=True)
    try:
        ret = subprocess.run(cmd).returncode
    except FileNotFoundError:
        sys.exit(f"error: `{cmd[0]}` not found — install COLMAP or pass "
                 "--colmap_executable")
    if ret != 0:
        sys.exit(f"error: `{' '.join(cmd[:2])}` failed with code {ret}")


def convert(source_path: str, camera: str = "OPENCV",
            colmap_executable: str = "colmap", no_gpu: bool = False,
            skip_matching: bool = False, resize: bool = False) -> None:
    use_gpu = "0" if no_gpu else "1"
    db = os.path.join(source_path, "distorted", "database.db")
    if not skip_matching:
        os.makedirs(os.path.join(source_path, "distorted", "sparse"),
                    exist_ok=True)
        _run([colmap_executable, "feature_extractor",
              "--database_path", db,
              "--image_path", os.path.join(source_path, "input"),
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", camera,
              "--SiftExtraction.use_gpu", use_gpu])
        _run([colmap_executable, "exhaustive_matcher",
              "--database_path", db,
              "--SiftMatching.use_gpu", use_gpu])
        _run([colmap_executable, "mapper",
              "--database_path", db,
              "--image_path", os.path.join(source_path, "input"),
              "--output_path", os.path.join(source_path, "distorted",
                                            "sparse"),
              "--Mapper.ba_global_function_tolerance=0.000001"])

    _run([colmap_executable, "image_undistorter",
          "--image_path", os.path.join(source_path, "input"),
          "--input_path", os.path.join(source_path, "distorted", "sparse",
                                       "0"),
          "--output_path", source_path,
          "--output_type", "COLMAP"])

    # move sparse/* into sparse/0 (convert.py:76-86)
    sparse = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if resize:
        _resize_images(source_path)


def _resize_images(source_path: str) -> None:
    """images_2/_4/_8 pyramids via PIL (convert.py:88-97 uses magick)."""
    from PIL import Image
    src = os.path.join(source_path, "images")
    for div in (2, 4, 8):
        dst = os.path.join(source_path, f"images_{div}")
        os.makedirs(dst, exist_ok=True)
        for fname in os.listdir(src):
            img = Image.open(os.path.join(src, fname))
            img = img.resize((img.width // div, img.height // div),
                             Image.LANCZOS)
            img.save(os.path.join(dst, fname))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Colmap converter")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--resize", action="store_true")
    a = p.parse_args(argv)
    convert(a.source_path, a.camera, a.colmap_executable, a.no_gpu,
            a.skip_matching, a.resize)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
