"""Tiled rasterizer (counterpart of d2dgs_tpu/ops/tiled_raster.py).

``blend_tiles`` takes one of two routes, as the JAX package does:
``RasterConfig.use_workqueue`` picks the work-queue route (each tile reads
its pairs through the sorted pair ranks; kernels K1/K2, ops/cuda/blend.py)
or the dense route (the pairs are first gathered into a [T, tile_cap, 18]
buffer; kernels K3/K4, ops/cuda/blend_dense.py).  On either route it
dispatches on the tensors' device: CUDA tensors go to the hand-written
kernels (the forward alone under no_grad, the forward/backward pair as one
autograd function when a gradient is wanted), CPU tensors to the plain
PyTorch versions (``blend_tiles_plain``, the port of the JAX package's XLA
tile blend, and ``blend_dense_plain``), differentiated by autograd.  Every
route returns the same per-tile state rows, laid out like the TPU
kernel's (d2dgs_tpu/ops/pallas/blend_tpu.py ROW_*).  Each tile blends at
most its ``tile_cap`` nearest pairs.
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
# the running accumulators a training forward checkpoints (T, dist1,
# dist2, colour, depth, normal, distortion), in csrc/blend_fwd.cu's order
CKPT_ROWS = (ROW_T, ROW_D1, ROW_D2, 4, 5, 6, ROW_DEPTH, 8, 9, 10,
             ROW_DISTORTION)
NCKPT = len(CKPT_ROWS)
# a plain walk's threshold-test rows (blend_walk with ``decisions``): T
# before and after the median pair, the pairs blended up to and with it,
# T after the tripping pair (NaN where there is none)
DEC_MED, DEC_MED_AFTER, DEC_N_MED, DEC_TRIP = 0, 1, 2, 3
NDEC = 4


def _tile_pixels(grid_x: int, tile_ids: torch.Tensor) -> torch.Tensor:
    """Pixel-center coordinates of the tiles ``tile_ids``: [T, PIX, 2]."""
    device = tile_ids.device
    t = tile_ids
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


def blend_walk(chunk_rows, count: torch.Tensor, grid_x: int, chunk: int,
               tile_ids: torch.Tensor, checkpoints: int | None = None,
               decisions: bool = False):
    """Blend each of T tiles' first ``count[t]`` pairs, ``chunk`` at a
    time: ``chunk_rows(c0)`` gives the features [T, chunk, NFEAT] of rows
    c0..c0+chunk-1 of every tile (any values past a tile's count);
    ``tile_ids`` [T] the tiles' grid indices.  Returns the state rows
    [T, NSTATE, PIX].

    With ``checkpoints=seg`` (a multiple of ``chunk``) it returns
    ``(rows, ckpt, records)``, the training mode of the kernels: ckpt
    [T, n, NCKPT, PIX] holds rows ``CKPT_ROWS`` of the state after pairs
    [0, k*seg) for k = 1..n, n = ceil(max(count) / seg) - 1 (a tile's
    final state past its own count), and records [T, 2, PIX] int32 the
    position of each pixel's last blended pair and of its median pair
    (-1 for none).  With ``decisions`` (and no ``checkpoints``) it returns
    ``(rows, dec)``: dec [T, NDEC, PIX] the transmittances the walk's
    threshold tests read (rows DEC_*; ``BlendState``'s ``t_med``,
    ``t_med_after``, ``n_med``, ``t_trip``), for judging a kernel's flips
    (``ops/cuda/blend.compare_states``).  The state rows do not change."""
    num_tiles = count.shape[0]
    dev = tile_ids.device
    pix = _tile_pixels(grid_x, tile_ids)                    # [T,P,2]
    state = B.init_state((num_tiles, PIX), device=dev,
                         positions=checkpoints is not None,
                         decisions=decisions)
    count = count.long()
    max_count = int(count.max()) if num_tiles else 0
    if checkpoints is not None and checkpoints % chunk:
        raise ValueError(f"checkpoints={checkpoints} is not a multiple of "
                         f"chunk={chunk}")
    ckpt = []
    lane = torch.arange(chunk, device=dev)
    for c0 in range(0, max_count, chunk):
        if checkpoints is not None and c0 and c0 % checkpoints == 0:
            ckpt.append(_state_rows(state)[:, list(CKPT_ROWS)])
        in_range = lane[None, :] < (count - c0)[:, None]
        g = chunk_rows(c0)                                   # [T,chunk,NFEAT]
        opac = torch.where(in_range, g[..., 17], 0.0)
        alpha, depth = B.pixel_responses(
            g[..., 0:9].reshape(num_tiles, chunk, 3, 3), g[..., 9:11],
            opac, pix)
        state = B.blend_chunk(state, alpha, depth, g[..., 14:17],
                              g[..., 11:14],
                              n_rows=torch.clamp(count - c0, 0, chunk),
                              offset=c0)
    rows = _state_rows(state)
    if decisions:
        return rows, torch.stack([state.t_med, state.t_med_after,
                                  state.n_med, state.t_trip], dim=1)
    if checkpoints is None:
        return rows
    ckpt = torch.stack(ckpt, dim=1) if ckpt else \
        rows.new_zeros((num_tiles, 0, NCKPT, PIX))
    records = torch.stack([state.last, state.med], dim=1).to(torch.int32)
    return rows, ckpt, records


def _state_rows(state) -> torch.Tensor:
    """BlendState -> the state rows [T, NSTATE, PIX]."""
    rows = [state.T, state.done.to(torch.float32), state.dist1, state.dist2,
            *state.color.unbind(-1), state.depth, *state.normal.unbind(-1),
            state.distortion, state.med_depth, state.med_weight,
            state.n_eval, state.n_blend]
    return torch.stack(rows, dim=1)                          # [T,16,P]


def blend_tiles_plain(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
                      tile_start: torch.Tensor, tile_count: torch.Tensor,
                      grid_x: int, chunk: int = 64,
                      tile_ids: torch.Tensor | None = None,
                      decisions: bool = False):
    """Blend every tile's pair list in chunks (port of blend_tiles_xla).

    feats_sorted: [N, NFEAT] features in depth order (feats[order]);
    pair_rank [B], tile_start [T], tile_count [T]: int32 from
    ``bin_gaussians`` (the count clamped at ``tile_cap`` by the caller).
    ``tile_ids`` (optional) gives the grid index of each of the T tiles,
    when they are a subset of the grid (default: the whole grid in
    order).  Returns the state rows [T, NSTATE, PIX]; with ``decisions``
    also the threshold-test rows [T, NDEC, PIX] (``blend_walk``)."""
    dev = feats_sorted.device
    if tile_ids is None:
        tile_ids = torch.arange(tile_start.shape[0], device=dev)
    start = tile_start.long()
    n_pairs = pair_rank.shape[0]
    lane = torch.arange(chunk, device=dev)

    def chunk_rows(c0):
        offs = torch.clamp(start[:, None] + c0 + lane[None, :], 0,
                           n_pairs - 1)
        return feats_sorted[pair_rank[offs].long()]
    return blend_walk(chunk_rows, tile_count, grid_x, chunk, tile_ids,
                      decisions=decisions)


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

    Returns (tile_color [T,P,3], tile_allmap [T,P,8], overflow 0-d int32:
    the pairs dropped by the per-tile ``tile_cap``, each tile's deepest).
    """
    from .cuda.blend import BlendTiles, blend_fwd
    from .cuda.blend_dense import BlendTilesDense, blend_dense_fwd, build_gdata
    feats = pack_features(Tmat, center, normal, colors, opacity)
    overflow = torch.sum(torch.clamp_min(
        binning.tile_count - cfg.tile_cap, 0)).to(torch.int32)
    train = (feats.device.type == "cuda" and torch.is_grad_enabled()
             and feats.requires_grad)
    if cfg.use_workqueue:
        counts = torch.clamp_max(binning.tile_count, cfg.tile_cap)
        feats_sorted = feats[binning.order.long()].contiguous()
        args = (feats_sorted, binning.pair_rank, binning.tile_start, counts,
                grid_x, cfg.chunk)
        state = BlendTiles.apply(*args) if train else blend_fwd(*args)
    else:
        gdata, counts = build_gdata(feats, binning, cfg.tile_cap)
        n_pairs = binning.pair_rank.shape[0]   # sizes K3's work, no read
        state = BlendTilesDense.apply(gdata, counts, grid_x, n_pairs,
                                      cfg.chunk) if train \
            else blend_dense_fwd(gdata, counts, grid_x, cfg.chunk,
                                 max_pairs=n_pairs)
    tile_color, tile_allmap = state_to_maps(state)
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
