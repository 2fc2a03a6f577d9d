"""Dense (no-binning) renderer: the ground truth for the kernel tests
(counterpart of d2dgs_tpu/ops/dense_raster.py).

Blends every Gaussian against every pixel in one chunk, with the same
tile-membership mask the binned renderers apply.  O(N*H*W) memory: small
scenes and tests only.
"""
from __future__ import annotations

import torch

from ..config import TILE
from ..data.cameras import Camera
from . import blend as B
from .binning import circles_tile_hit, visibility_circles
from .projection import preprocess


def rasterize_dense(means3d, scales, quats, opacities, colors, cam: Camera,
                    bg=None, scale_modifier: float = 1.0,
                    tile_circle_cull: bool = True):
    """Render [H,W,3] color + [H,W,8] allmap.

    colors: [N,3] precomputed RGB; opacities: [N] post-sigmoid.
    Returns (color, allmap, radii, prep).
    """
    H, W = cam.H, cam.W
    dev = means3d.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    prep = preprocess(means3d, scales, quats, cam, scale_modifier)

    # depth-sorted order (stable; invalid Gaussians last with zero alpha)
    key = torch.where(prep.valid, prep.depth,
                      torch.full_like(prep.depth, float("inf")))
    order = torch.sort(key, stable=True).indices

    opac_all = torch.where(prep.valid, opacities, 0.0)
    T = prep.T[order]
    center = prep.center[order]
    normal = prep.normal[order]
    col = colors[order]
    opac = opac_all[order]
    rmin = prep.rect_min[order]
    rmax = prep.rect_max[order]

    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pix = torch.stack([xs + 0.5, ys + 0.5], dim=-1).to(torch.float32)
    tx = (xs // TILE).to(torch.int32)
    ty = (ys // TILE).to(torch.int32)

    alpha, depth_px = B.pixel_responses(T, center, opac, pix)      # [G,P]
    in_tile = ((tx[None, :] >= rmin[:, 0:1]) & (tx[None, :] < rmax[:, 0:1])
               & (ty[None, :] >= rmin[:, 1:2]) & (ty[None, :] < rmax[:, 1:2]))
    if tile_circle_cull:
        # the binned paths' exact visibility-circle test, in sorted order
        vc = visibility_circles(prep, opac_all)
        vc_s = type(vc)(*(a[order][..., None, :] if a.ndim == 2
                          else a[order][:, None] for a in vc))
        in_tile &= circles_tile_hit(vc_s, tx[None, :], ty[None, :])
    alpha = torch.where(in_tile, alpha, 0.0)

    state = B.init_state((H * W,), device=dev)
    state = B.blend_chunk(state, alpha, depth_px, col, normal)
    color_img, allmap = B.finalize(state, bg)
    return (color_img.reshape(H, W, 3), allmap.reshape(H, W, 8),
            prep.radius, prep)
