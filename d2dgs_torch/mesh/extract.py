"""Mesh reconstruction (counterpart of d2dgs_tpu/mesh/extract.py, the
reference's GaussianExtractor, utils/mesh_utils.py:93-199 and
render_mesh.py:86-240).

Per timestamp: render every training camera at that time (deformed),
mask the median ("surf") depth by the gt alpha mask and the RGB
background test (depth_filtering), fuse into a TSDF volume on the
device, extract the mesh and keep its largest clusters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.deform import DeformConfig, deform_gaussians
from ..render.renderer import render
from .tsdf import (extract_mesh, integrate_view, largest_components,
                   make_volume, sample_colors)


def auto_bounds(gauss, nodes, deform_cfg, mesh_time: float, voxel: float):
    """The deformed alive splats' box at ``mesh_time``, padded by 5% of
    its largest side plus one voxel (host float32, as the JAX package)."""
    t = torch.tensor(mesh_time, dtype=torch.float32, device=gauss.xyz.device)
    with torch.no_grad():
        d0 = deform_gaussians(nodes, deform_cfg, gauss, t)
        xyz = (gauss.xyz + d0["d_xyz"]).cpu().numpy()
    am = gauss.alive.cpu().numpy()
    xyz = xyz[am] if am.any() else xyz
    span = xyz.max(0) - xyz.min(0)
    pad = 0.05 * float(span.max()) + voxel
    return tuple(xyz.min(0) - pad), tuple(xyz.max(0) + pad)


class _Clock:
    """Wall-time laps with the device synchronised."""

    def __init__(self, device):
        self.device = device
        self.t = self._now()

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self) -> float:
        now = self._now()
        ms, self.t = (now - self.t) * 1e3, now
        return ms


@torch.no_grad()
def reconstruct_mesh(cameras, gauss, nodes, node_cfg, raster_cfg,
                     mesh_time: float, bg=None,
                     alpha_masks=None,
                     bounds="auto",
                     voxel: float = 0.008, depth_trunc: float = 6.0,
                     keep_clusters: int = 1,
                     depth_filtering: bool = True,
                     return_colors: bool = False,
                     deform_cfg=None, report: dict | None = None):
    """cameras: list[Camera]; alpha_masks: optional list of [H,W,1] gt
    masks (depth zeroed where mask < 0.5, mesh_utils.py:185-186).
    ``bounds``: explicit ((min), (max)) world box, or "auto" (see
    ``auto_bounds``).  ``report`` (optional dict) receives the grid's
    dims, voxels and bytes, and the wall time of the renders and fusion
    (``integrate_ms``) and of the extraction and filter (``extract_ms``),
    the device synchronised.  Returns (verts, faces) or (verts, faces,
    vert_colors), numpy on the host."""
    dev = gauss.xyz.device
    bg = torch.zeros(3, device=dev) if bg is None else \
        torch.as_tensor(bg, dtype=torch.float32, device=dev)
    if deform_cfg is None:
        deform_cfg = DeformConfig(deform_type="node", node=node_cfg)
    if bounds == "auto":
        bounds = auto_bounds(gauss, nodes, deform_cfg, mesh_time, voxel)
    vol = make_volume(bounds[0], bounds[1], voxel=voxel, device=dev)
    if report is not None:
        report["dims"] = tuple(vol.tsdf.shape)
        report["voxels"] = vol.tsdf.numel()
        report["bytes"] = sum(a.numel() * a.element_size()
                              for a in (vol.tsdf, vol.weight, vol.color))
    clock = _Clock(dev)
    t = torch.tensor(mesh_time, dtype=torch.float32, device=dev)
    d = deform_gaussians(nodes, deform_cfg, gauss, t)
    for i, cam in enumerate(cameras):
        out = render(cam, gauss, bg, d_xyz=d["d_xyz"],
                     d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                     depth_filtering=depth_filtering, cfg=raster_cfg)
        depth = out.depth[..., 0]
        if alpha_masks is not None and alpha_masks[i] is not None:
            m = torch.as_tensor(alpha_masks[i], device=dev)[..., 0] >= 0.5
            depth = torch.where(m, depth, 0.0)
        integrate_view(vol, depth, out.image, cam, depth_trunc=depth_trunc)
    integrate_ms = clock.lap()

    verts, faces = extract_mesh(vol)
    if keep_clusters > 0 and faces.shape[0] > 0:
        verts, faces = largest_components(verts, faces, keep=keep_clusters)
    if report is not None:
        report["integrate_ms"] = integrate_ms
        report["extract_ms"] = clock.lap()
    if not return_colors:
        return verts, faces
    if verts.shape[0] == 0:
        return verts, faces, np.zeros((0, 3), np.float32)
    colors = sample_colors(vol, torch.as_tensor(verts, device=dev))
    return verts, faces, colors.cpu().numpy()
