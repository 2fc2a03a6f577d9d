"""Test-set rendering and metrics (counterpart of
d2dgs_tpu/eval/render_sets.py, the reference's render.py:render_set,
render.py:33-90): render every camera of a split at its time, save the
rgb, gt and depth images, and aggregate PSNR/SSIM/MS-SSIM(/LPIPS) into
the dict metrics.py:92-95 writes as results.json.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import trace
from ..models.deform import DeformConfig, deform_gaussians
from ..render.renderer import render
from .metrics import evaluate_image_metrics


def _save_png(path, img):
    from PIL import Image
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    Image.fromarray(np.clip(np.asarray(img) * 255.0, 0, 255)
                    .astype(np.uint8)).save(path)


@torch.no_grad()
def render_view(cam, gauss, nodes, deform_cfg, raster_cfg, bg,
                depth_filtering: bool = False):
    """The node warp at the camera's time, then the render."""
    with trace.span("d2dgs.view"):
        d = deform_gaussians(nodes, deform_cfg, gauss, cam.time)
        return render(cam, gauss, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                      depth_filtering=depth_filtering, cfg=raster_cfg)


def render_test_set(samples, gauss, nodes, node_cfg, raster_cfg,
                    out_dir: str | None = None, bg=None,
                    lpips_weights: str | None = None,
                    save_images: bool = True,
                    deform_cfg=None, return_images: int = 0) -> dict:
    """samples: list of data.dnerf.CameraSample (or (camera, gt) pairs).
    deform_cfg: optional models.deform.DeformConfig, by default the node
    warp over ``node_cfg``.  Returns {"per_view": [...], "mean": {...}};
    with return_images=k the first k views' (render, gt) uint8 arrays are
    under "images" (training-time reporting, train.py:54-142)."""
    dev = gauss.xyz.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    if deform_cfg is None:
        deform_cfg = DeformConfig(deform_type="node", node=node_cfg)

    if out_dir and save_images:
        for sub in ("renders", "depth", "gt"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    per_view, images = [], []
    to8 = lambda a: np.clip(np.asarray(a) * 255.0, 0, 255).astype(np.uint8)
    for i, s in enumerate(samples):
        if hasattr(s, "camera"):
            cam, gt = s.camera, s.gt(bg.cpu().numpy())
        else:
            cam, gt = s[0], s[1]
        gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        out = render_view(cam, gauss, nodes, deform_cfg, raster_cfg, bg)
        img, depth = out.image, out.depth
        m = evaluate_image_metrics(img, gt, lpips_weights)
        m["view"] = i
        per_view.append(m)
        if i < return_images:
            images.append((to8(img.cpu().numpy()), to8(gt.cpu().numpy())))
        if out_dir and save_images:
            _save_png(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
            _save_png(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt)
            dmax = float(torch.max(depth)) or 1.0
            _save_png(os.path.join(out_dir, "depth", f"{i:05d}.png"),
                      (depth / dmax).expand(*depth.shape[:2], 3))

    keys = [k for k in per_view[0] if k != "view"]
    mean = {k: float(np.mean([v[k] for v in per_view])) for k in keys}
    result = {"per_view": per_view, "mean": mean}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(result, f, indent=2)
    if return_images:
        result["images"] = images
    return result
