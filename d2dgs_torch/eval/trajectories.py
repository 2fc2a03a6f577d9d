"""Camera trajectories and trajectory rendering (counterpart of
d2dgs_tpu/eval/trajectories.py): render.py:92-170's time sweep and
spiral/orbit modes and utils/render_utils.py:203-268's ellipse paths,
written as PNG frames and an animated GIF (no ffmpeg), and
render_mesh_trajectory.py's per-frame mesh extraction and re-render.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.cameras import Camera, orbit_camera
from ..models.deform import DeformConfig
from .render_sets import render_view


def ellipse_path(n_frames: int, radius: float, elevation: float,
                 fov: float, H: int, W: int,
                 target=(0.0, 0.0, 0.0), z_variation: float = 0.0,
                 times=None, device="cuda") -> list[Camera]:
    """Orbit/ellipse of cameras around `target`.  `times`: None -> all
    t=0; "sweep" -> t ramps 0..1; array -> per-frame timestamps."""
    cams = []
    for i in range(n_frames):
        az = 2.0 * np.pi * i / n_frames
        el = elevation + z_variation * np.sin(2.0 * np.pi * i / n_frames)
        if times is None:
            t = 0.0
        elif isinstance(times, str) and times == "sweep":
            t = i / max(n_frames - 1, 1)
        else:
            t = float(np.asarray(times)[i])
        cams.append(orbit_camera(az, el, radius, fov, H, W, time=t,
                                 target=target, device=device))
    return cams


def time_sweep_cameras(cam: Camera, n_frames: int) -> list[Camera]:
    """Fixed viewpoint, t in [0,1] (render.py's `time_interpolate`)."""
    return [dataclasses.replace(cam, time=torch.tensor(
        i / max(n_frames - 1, 1), dtype=torch.float32, device=cam.device))
        for i in range(n_frames)]


def render_trajectory(cams, gauss, nodes, node_cfg, raster_cfg,
                      out_dir: str | None = None, bg=None,
                      save_video: bool = True,
                      video_name: str = "video.gif",
                      fps: int = 20, deform_cfg=None) -> list[np.ndarray]:
    """Render cameras of one size with the deformation at each camera's
    time; save the frames as PNGs and an animated GIF."""
    dev = gauss.xyz.device
    bg = torch.zeros(3, device=dev) if bg is None else \
        torch.as_tensor(bg, dtype=torch.float32, device=dev)
    if deform_cfg is None:
        deform_cfg = DeformConfig(deform_type="node", node=node_cfg)
    frames = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for i, cam in enumerate(cams):
        img = render_view(cam, gauss, nodes, deform_cfg, raster_cfg,
                          bg).image
        img = np.clip(img.cpu().numpy(), 0.0, 1.0)
        frames.append(img)
        if out_dir:
            from PIL import Image
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"{i:05d}.png"))
    if out_dir and save_video and frames:
        save_gif(os.path.join(out_dir, video_name), frames, fps=fps)
    return frames


def render_mesh_trajectory(cams, train_cams, gauss, nodes, node_cfg,
                           raster_cfg, out_dir: str, alpha_masks=None,
                           voxel: float = 0.008, keep_clusters: int = 1,
                           bg=None, deform_cfg=None):
    """Per-trajectory-frame mesh extraction and re-render
    (render_mesh_trajectory.py): for each trajectory camera, fuse a mesh
    at that camera's time from the training views, then render it with
    the mesh rasterizer from the trajectory viewpoint.  Writes
    ``mesh_NNNN.ply``, ``mesh_image/`` and ``mesh_shape/`` PNGs and a GIF
    of each; returns the (image, shape) frames as host arrays."""
    from ..mesh.extract import reconstruct_mesh
    from ..mesh.render import write_mesh_renders
    from ..mesh.tsdf import save_mesh_ply
    os.makedirs(out_dir, exist_ok=True)
    shape_frames, image_frames = [], []
    for i, cam in enumerate(cams):
        verts, faces, colors = reconstruct_mesh(
            train_cams, gauss, nodes, node_cfg, raster_cfg,
            mesh_time=float(cam.time), bg=bg, alpha_masks=alpha_masks,
            voxel=voxel, keep_clusters=keep_clusters, return_colors=True,
            deform_cfg=deform_cfg)
        save_mesh_ply(os.path.join(out_dir, f"mesh_{i:04d}.ply"),
                      verts, faces, colors=colors)
        if faces.shape[0] == 0:
            continue
        img, shp = write_mesh_renders(cam, verts, faces, colors, out_dir, i)
        image_frames.append(img)
        shape_frames.append(shp)
    if image_frames:
        save_gif(os.path.join(out_dir, "mesh_image.gif"), image_frames)
        save_gif(os.path.join(out_dir, "mesh_shape.gif"), shape_frames)
    return image_frames, shape_frames


def save_gif(path: str, frames, fps: int = 20) -> None:
    from PIL import Image
    ims = [Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
           for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=max(int(1000 / fps), 20), loop=0)
