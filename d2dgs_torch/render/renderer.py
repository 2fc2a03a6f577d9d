"""High-level render() (counterpart of d2dgs_tpu/render/renderer.py, the
reference's gaussian_renderer/__init__.py:41-219).

Assembles deformed Gaussian parameters, evaluates SH, rasterizes, and
post-processes the aux maps.  The work runs on the device of ``params``
(the camera must be on the same one): CUDA tensors blend through the
hand-written kernels (the work-queue or the dense route, as
``RasterConfig.use_workqueue`` says), CPU tensors through their plain
versions.

``render_flow`` renders the optical-flow term's per-pixel motion
through the 3DGS rasterizer (``ops/raster3d.py``, plain torch on either
device).

Densification statistics: the reference's backward overwrites the
screen-space gradient with dL_dmean2D.x = dL_dTu.z * Tw.z * (W/2).  A
zero-valued ``screen_probe`` added to (Tu.z, Tv.z), pre-scaled by the
detached Tw.z * W/2, has exactly that gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..config import RasterConfig
from ..data.cameras import Camera
from ..models.gaussians import GaussianParams, apply_deform
from ..ops.binning import bin_gaussians
from ..ops.projection import matmul_fma, preprocess, tile_grid
from ..ops.raster3d import rasterize_3dgs
from ..ops.tiled_raster import blend_tiles, tiles_to_image
from ..utils.quaternion import quat_normalize
from ..utils.sh import sh_to_rgb


class RenderOutput(NamedTuple):
    image: torch.Tensor        # [H,W,3]
    alpha: torch.Tensor        # [H,W,1]
    rend_normal: torch.Tensor  # [H,W,3] world-frame alpha-weighted normal
    rend_dist: torch.Tensor    # [H,W,1] distortion map
    depth: torch.Tensor        # [H,W,1] surf depth (median by default)
    surf_normal: torch.Tensor  # [H,W,3] pseudo-normal from depth
    radii: torch.Tensor        # [N]
    visibility: torch.Tensor   # [N] bool: radii > 0
    allmap: torch.Tensor       # [H,W,8] raw aux channels
    num_pairs: torch.Tensor    # 0-d: binned pair count (load metric)
    overflow: torch.Tensor     # 0-d int32: pairs dropped by tile_cap
    clamped: torch.Tensor      # 0-d int32, always 0 (emission sized exactly)


def depth_to_normal(cam: Camera, depth: torch.Tensor):
    """Backproject depth and finite-difference a normal map
    (utils/point_utils.py:9-41). depth: [H,W]. Returns ([H,W,3], points)."""
    H, W = cam.H, cam.W
    dev = depth.device
    trace.count("host.reads", 1)  # linalg.inv reads its error code back
    c2w = torch.linalg.inv(cam.w2c)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    # ray dirs through pixel corners (the reference uses arange)
    x = (xs - W / 2.0) / cam.fx
    y = (ys - H / 2.0) / cam.fy
    dirs_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    dirs_world = dirs_cam @ c2w[:3, :3].T
    points = depth[..., None] * dirs_world + c2w[:3, 3]
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy)
    # eps inside the sqrt: background pixels have exactly-zero normals
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    normal = torch.zeros_like(points)
    normal[1:-1, 1:-1] = n
    return normal, points


def postprocess_maps(cam: Camera, image: torch.Tensor, allmap: torch.Tensor,
                     bg: torch.Tensor, depth_filtering: bool,
                     cfg: RasterConfig):
    """Aux-map post-processing (gaussian_renderer/__init__.py:160-207):
    world-frame normals, expected/median surf depth, depth->pseudo-normal,
    mesh-export background masking."""
    H, W = image.shape[0], image.shape[1]
    if depth_filtering:
        white = torch.all(bg >= 0.95)
        mask_w = 1.0 - torch.all(image >= 0.95, dim=-1).to(torch.float32)
        mask_b = 1.0 - torch.all(image <= 0.05, dim=-1).to(torch.float32)
        mask = torch.where(white, mask_w, mask_b)[..., None]
    else:
        mask = torch.ones((H, W, 1), dtype=torch.float32, device=image.device)

    alpha = allmap[..., 1:2]
    # rotate camera-frame normals to world: n_w = R_w2c^T n_c
    rend_normal = (allmap[..., 2:5] @ cam.w2c[:3, :3]) * mask
    depth_median = torch.nan_to_num(allmap[..., 5:6], nan=0.0)
    depth_expected = torch.nan_to_num(allmap[..., 0:1] / torch.where(
        alpha == 0, 1.0, alpha), nan=0.0)
    rend_dist = allmap[..., 6:7] * mask
    surf_depth = (depth_expected * (1.0 - cfg.depth_ratio)
                  + cfg.depth_ratio * depth_median) * mask
    surf_normal, _ = depth_to_normal(cam, surf_depth[..., 0])
    surf_normal = surf_normal * alpha.detach() * mask
    return alpha, rend_normal, rend_dist, surf_depth, surf_normal


def render(cam: Camera, params: GaussianParams, bg: torch.Tensor,
           d_xyz=0.0, d_rotation=0.0, d_scaling=0.0, d_opacity=None,
           d_color=None, scaling_modifier: float = 1.0,
           override_color: torch.Tensor | None = None,
           screen_probe: torch.Tensor | None = None,
           depth_filtering: bool = False,
           cfg: RasterConfig = RasterConfig()) -> RenderOutput:
    if cam.device != params.xyz.device:
        raise ValueError(f"camera on {cam.device}, Gaussians on "
                         f"{params.xyz.device}")
    H, W = cam.H, cam.W
    gx, gy = tile_grid(H, W)

    with trace.span("d2dgs.project"):
        if trace.enabled():
            trace.count("render.live", params.alive.sum())
        means3d, scales, quats, opacity, sh = apply_deform(
            params, d_xyz, d_rotation, d_scaling, d_opacity, d_color)

        if override_color is not None:
            colors = override_color
        else:
            dirs = means3d - cam.cam_center[None, :]
            dirs = dirs / torch.sqrt(
                torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
            colors = sh_to_rgb(params.active_sh_degree, sh, dirs)

        prep = preprocess(means3d, scales, quats, cam, scaling_modifier)
        # dead capacity slots are culled outright (not merely transparent)
        valid = prep.valid & params.alive
        prep = prep._replace(valid=valid,
                             radius=torch.where(valid, prep.radius, 0))
        Tmat = prep.T
        if screen_probe is not None:
            # NDC gradient hack (see module docstring)
            probe = torch.zeros_like(Tmat)
            probe[:, 0, 2] = screen_probe[:, 0] * (
                Tmat[:, 2, 2] * (W / 2.0)).detach()
            probe[:, 1, 2] = screen_probe[:, 1] * (
                Tmat[:, 2, 2] * (H / 2.0)).detach()
            Tmat = Tmat + probe
        opac = torch.where(prep.valid, opacity, 0.0)

    with trace.span("d2dgs.bin"):
        binning = bin_gaussians(prep, gx, gy, cfg, opacity=opac)
    with trace.span("d2dgs.blend"):
        tile_color, tile_allmap, overflow = blend_tiles(
            Tmat, prep.center, prep.normal, colors, opac, binning, gx, gy,
            cfg)
        Tfinal = 1.0 - tile_allmap[..., 1:2]
        tile_color = tile_color + Tfinal * bg
        image = tiles_to_image(tile_color, gx, gy, H, W)
        allmap = tiles_to_image(tile_allmap, gx, gy, H, W)

        (alpha, rend_normal, rend_dist, surf_depth,
         surf_normal) = postprocess_maps(cam, image, allmap, bg,
                                         depth_filtering, cfg)

    return RenderOutput(
        image=image, alpha=alpha, rend_normal=rend_normal,
        rend_dist=rend_dist, depth=surf_depth, surf_normal=surf_normal,
        radii=prep.radius, visibility=prep.radius > 0, allmap=allmap,
        num_pairs=binning.num_pairs, overflow=overflow,
        clamped=binning.clamped)


def _full_proj_uvz(xyz: torch.Tensor, cam: Camera, znear: float = 0.01,
                   zfar: float = 100.0) -> torch.Tensor:
    """NDC uvz through the 3DGS full projection (render_flow,
    gaussian_renderer/__init__.py:259-266): P[0,0] = 1/tan(fovx/2) =
    2 fx / W."""
    z = torch.zeros((), dtype=torch.float32, device=xyz.device)
    row0 = torch.stack([2.0 * cam.fx / cam.W, z, z, z])
    row1 = torch.stack([z, 2.0 * cam.fy / cam.H, z, z])
    row2 = torch.tensor([0.0, 0.0, zfar / (zfar - znear),
                         -(zfar * znear) / (zfar - znear)],
                        dtype=torch.float32, device=xyz.device)
    row3 = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=torch.float32,
                        device=xyz.device)
    full = matmul_fma(torch.stack([row0, row1, row2, row3]), cam.w2c)
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    h = matmul_fma(hom[:, None, :], full.T)[:, 0]
    return h[:, :3] / (h[:, 3:4] + 1e-7)


def render_flow(params: GaussianParams, cam1: Camera, cam2: Camera | None,
                d_xyz1, d_xyz2, d_rotation1=0.0, d_scaling1=0.0,
                scaling_modifier: float = 1.0,
                scale_const: float | None = None,
                cfg: RasterConfig = RasterConfig()) -> dict:
    """Optical-flow rendering (gaussian_renderer/__init__.py:222-337): the
    uvz displacement of each Gaussian between (t1, cam1) and (t2, cam2)
    (cam1 again when cam2 is None), splatted through the 3DGS rasterizer
    as its colour, from the camera cam1.  Channel 2 carries the motion
    mask; the canonical positions enter the displacement detached.
    Returns the reference's dict: render, depth, alpha, radii,
    visibility_filter."""
    xyz_c = params.xyz.detach()
    uvz1 = _full_proj_uvz(xyz_c + d_xyz1, cam1)
    uvz2 = _full_proj_uvz(xyz_c + d_xyz2, cam1 if cam2 is None else cam2)
    flow = uvz2 - uvz1
    flow = torch.cat([flow[:, :2], params.motion_mask], dim=-1)

    means3d = params.xyz + d_xyz1
    if scale_const is not None:
        scales = torch.full_like(params.get_scaling, scale_const)
    else:
        scales = params.get_scaling + d_scaling1
    quats = quat_normalize(params.rotation + d_rotation1, eps=1e-12)
    opacity = torch.where(params.alive, params.get_opacity[:, 0], 0.0)

    image, radii, depth, alpha = rasterize_3dgs(
        means3d, scales, quats, opacity, flow, cam1,
        scale_modifier=scaling_modifier, cfg=cfg)
    return dict(render=image, depth=depth, alpha=alpha, radii=radii,
                visibility_filter=radii > 0)
