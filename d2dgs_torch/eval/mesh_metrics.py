"""Mesh-image metrics and chamfer distance (counterpart of
d2dgs_tpu/eval/mesh_metrics.py, the reference's metrics_mesh.py:1-75 and
DG-Mesh's chamfer).

* ``mesh_image_metrics(renders_dir, gt_dir, ...)``: PSNR/SSIM/MS-SSIM
  (/LPIPS substitute) over render/gt files paired by zero-padded stem,
  written to ``<name>_results.json``.
* ``chamfer_distance(a, b)``: symmetric point-set chamfer with the exact
  KNN op; ``mesh_chamfer`` samples both surfaces first.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.knn import knn
from ..utils.general import resolve_device
from .metrics import evaluate_image_metrics


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path), np.float32) / 255.0
    return img[..., :3] if img.ndim == 3 else np.repeat(
        img[..., None], 3, axis=-1)


def mesh_image_metrics(renders_dir: str, gt_dir: str,
                       out_dir: str | None = None,
                       name: str = "mesh_render",
                       lpips_weights: str | None = None,
                       device="cuda") -> dict:
    """Pairs render files with gt files by zero-padded stem
    (metrics_mesh.py readImages:14-30), evaluates the image metrics on
    ``device``, writes ``<out_dir>/<name>_results.json`` and returns the
    mean dict."""
    dev = resolve_device(device)
    per_view = []
    for fname in sorted(os.listdir(renders_dir)):
        stem = fname.split(".")[0]
        if len(stem) > 5 or not stem.isdigit():
            continue
        gt_path = os.path.join(gt_dir, stem.zfill(5) + ".png")
        if not os.path.exists(gt_path):
            continue
        t = lambda p: torch.as_tensor(_load_image(p), device=dev)
        m = evaluate_image_metrics(t(os.path.join(renders_dir, fname)),
                                   t(gt_path), lpips_weights)
        m["view"] = stem
        per_view.append(m)
    if not per_view:
        raise FileNotFoundError(
            f"no matching render/gt pairs in {renders_dir} vs {gt_dir}")
    keys = [k for k in per_view[0] if k != "view"]
    mean = {k: float(np.mean([v[k] for v in per_view])) for k in keys}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}_results.json"), "w") as f:
            json.dump({"mean": mean, "per_view": per_view}, f, indent=2)
    return mean


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples [n,3] (for chamfer)."""
    rng = np.random.RandomState(seed)
    v = verts[faces]                                   # [F,3,3]
    area = 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
    p = area / max(area.sum(), 1e-12)
    fi = rng.choice(faces.shape[0], n, p=p)
    r1, r2 = rng.rand(n, 1), rng.rand(n, 1)
    s = np.sqrt(r1)
    bary = np.concatenate([1 - s, s * (1 - r2), s * r2], axis=-1)
    return np.einsum("nk,nkd->nd", bary, v[fi]).astype(np.float32)


def chamfer_distance(a, b, device="cuda") -> float:
    """Symmetric mean chamfer distance between two point sets [*,3]."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    d_ab, _ = knn(a, b, 1)
    d_ba, _ = knn(b, a, 1)
    return float(torch.mean(torch.sqrt(torch.clamp_min(d_ab, 0.0)))
                 + torch.mean(torch.sqrt(torch.clamp_min(d_ba, 0.0))))


def mesh_chamfer(verts_pred, faces_pred, verts_gt, faces_gt,
                 n_samples: int = 30_000, seed: int = 0,
                 device="cuda") -> float:
    """Chamfer between two meshes via surface sampling (DG-Mesh eval)."""
    pa = sample_mesh_surface(np.asarray(verts_pred),
                             np.asarray(faces_pred), n_samples, seed)
    pb = sample_mesh_surface(np.asarray(verts_gt),
                             np.asarray(faces_gt), n_samples, seed + 1)
    return chamfer_distance(pa, pb, device=device)
