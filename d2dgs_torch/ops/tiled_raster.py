"""Tiled rasterizer (counterpart of d2dgs_tpu/ops/tiled_raster.py).

``blend_tiles`` dispatches on the tensors' device: CUDA tensors go to the
hand-written blend kernel (ops/cuda/blend.py), CPU tensors to
``blend_tiles_plain``, the plain PyTorch port of the JAX package's XLA
tile blend.  Both return the same per-tile state rows, laid out like the
TPU kernel's (d2dgs_tpu/ops/pallas/blend_tpu.py ROW_*).
"""
from __future__ import annotations

import torch

from ..config import TILE, RasterConfig
from ..data.cameras import Camera
from . import blend as B
from .binning import Binning, bin_gaussians
from .projection import preprocess, tile_grid

PIX = TILE * TILE      # 256 pixels per tile
NFEAT = 18             # Tmat(9) center(2) normal(3) color(3) opacity(1)
NSTATE = 16            # state rows per pixel

# state-row layout (rows 0-13 as the TPU kernel's)
ROW_T, ROW_DONE, ROW_D1, ROW_D2 = 0, 1, 2, 3
ROW_COLOR = slice(4, 7)
ROW_DEPTH = 7
ROW_NORMAL = slice(8, 11)
ROW_DISTORTION = 11
ROW_MED_D = 12
ROW_MED_W = 13
ROW_N_EVAL = 14        # pairs evaluated per pixel (work counter)
ROW_N_BLEND = 15       # pairs blended per pixel (work counter)


def _tile_pixels(grid_x: int, num_tiles: int, device) -> torch.Tensor:
    """Pixel-center coordinates for every tile: [T, PIX, 2]."""
    t = torch.arange(num_tiles, device=device)
    bx = (t % grid_x) * TILE
    by = (t // grid_x) * TILE
    o = torch.arange(PIX, device=device)
    px = bx[:, None] + (o % TILE)[None, :]
    py = by[:, None] + (o // TILE)[None, :]
    return torch.stack([px + 0.5, py + 0.5], dim=-1).to(torch.float32)


def pack_features(Tmat, center, normal, colors, opacity) -> torch.Tensor:
    """Per-Gaussian blend features [N, NFEAT]."""
    n = Tmat.shape[0]
    return torch.cat([Tmat.reshape(n, 9), center, normal, colors,
                      opacity[:, None]], dim=-1)


def blend_tiles_plain(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
                      tile_start: torch.Tensor, tile_count: torch.Tensor,
                      grid_x: int, chunk: int = 64) -> torch.Tensor:
    """Blend every tile's pair list in chunks (port of blend_tiles_xla).

    feats_sorted: [N, NFEAT] features in depth order (feats[order]);
    pair_rank [B], tile_start [T], tile_count [T]: int32 from
    ``bin_gaussians``.  Returns the state rows [T, NSTATE, PIX].
    """
    num_tiles = tile_start.shape[0]
    dev = feats_sorted.device
    pix = _tile_pixels(grid_x, num_tiles, dev)              # [T,P,2]
    state = B.init_state((num_tiles, PIX), device=dev)
    start = tile_start.long()
    count = tile_count.long()
    n_pairs = pair_rank.shape[0]
    max_count = int(count.max()) if num_tiles else 0
    lane = torch.arange(chunk, device=dev)
    for c0 in range(0, max_count, chunk):
        offs = start[:, None] + c0 + lane[None, :]           # [T,chunk]
        in_range = lane[None, :] < (count - c0)[:, None]
        offs = torch.clamp(offs, 0, n_pairs - 1)
        g = feats_sorted[pair_rank[offs].long()]             # [T,chunk,NFEAT]
        opac = torch.where(in_range, g[..., 17], 0.0)
        alpha, depth = B.pixel_responses(
            g[..., 0:9].reshape(num_tiles, chunk, 3, 3), g[..., 9:11],
            opac, pix)
        state = B.blend_chunk(state, alpha, depth, g[..., 14:17],
                              g[..., 11:14],
                              n_rows=torch.clamp(count - c0, 0, chunk))
    rows = [state.T, state.done.to(torch.float32), state.dist1, state.dist2,
            *state.color.unbind(-1), state.depth, *state.normal.unbind(-1),
            state.distortion, state.med_depth, state.med_weight,
            state.n_eval, state.n_blend]
    return torch.stack(rows, dim=1)                          # [T,16,P]


def state_to_maps(state: torch.Tensor):
    """State rows [T, NSTATE, PIX] -> (tile_color [T,P,3],
    tile_allmap [T,P,8]) in the reference allmap layout (zero bg)."""
    st = state.transpose(1, 2)                               # [T,P,NSTATE]
    tile_color = st[..., ROW_COLOR]
    tile_allmap = torch.cat([
        st[..., ROW_DEPTH:ROW_DEPTH + 1],       # expected-depth accumulator
        1.0 - st[..., ROW_T:ROW_T + 1],         # alpha = 1 - T_final
        st[..., ROW_NORMAL],                    # camera-frame normal
        st[..., ROW_MED_D:ROW_MED_D + 1],       # median depth
        st[..., ROW_DISTORTION:ROW_DISTORTION + 1],
        st[..., ROW_MED_W:ROW_MED_W + 1],
    ], dim=-1)
    return tile_color, tile_allmap


def blend_tiles(Tmat, center, normal, colors, opacity, binning: Binning,
                grid_x: int, grid_y: int, cfg: RasterConfig):
    """Blend all tiles; per-Gaussian inputs are in ORIGINAL index space.

    Returns (tile_color [T,P,3], tile_allmap [T,P,8], overflow 0-d int32,
    always 0: the pair buffers are sized from the measured counts).
    """
    from .cuda.blend import blend_fwd
    feats = pack_features(Tmat, center, normal, colors, opacity)
    feats_sorted = feats[binning.order.long()].contiguous()
    state = blend_fwd(feats_sorted, binning.pair_rank, binning.tile_start,
                      binning.tile_count, grid_x, chunk=cfg.chunk)
    tile_color, tile_allmap = state_to_maps(state)
    overflow = torch.zeros((), dtype=torch.int32, device=feats.device)
    return tile_color, tile_allmap, overflow


def tiles_to_image(tile_img: torch.Tensor, grid_x: int, grid_y: int,
                   H: int, W: int) -> torch.Tensor:
    """[T, TILE*TILE, C] -> [H, W, C] (cropping tile padding)."""
    C = tile_img.shape[-1]
    img = tile_img.reshape(grid_y, grid_x, TILE, TILE, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, C)
    return img[:H, :W]


def rasterize_tiled(means3d, scales, quats, opacities, colors, cam: Camera,
                    bg=None, scale_modifier: float = 1.0,
                    cfg: RasterConfig = RasterConfig()):
    """Full tiled pipeline: preprocess -> bin -> blend -> assemble.
    Same contract as rasterize_dense; returns (color, allmap, radii,
    prep, binning)."""
    H, W = cam.H, cam.W
    gx, gy = tile_grid(H, W)
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=means3d.device)
    prep = preprocess(means3d, scales, quats, cam, scale_modifier)
    opac = torch.where(prep.valid, opacities, 0.0)
    binning = bin_gaussians(prep, gx, gy, cfg, opacity=opac)
    tile_color, tile_allmap, _ = blend_tiles(
        prep.T, prep.center, prep.normal, colors, opac, binning, gx, gy, cfg)
    Tfinal = 1.0 - tile_allmap[..., 1:2]
    tile_color = tile_color + Tfinal * bg
    color = tiles_to_image(tile_color, gx, gy, H, W)
    allmap = tiles_to_image(tile_allmap, gx, gy, H, W)
    return color, allmap, prep.radius, prep, binning
