"""Rasterizer constants and configuration (counterpart of d2dgs_tpu/config.py).

The numeric constants mirror the reference CUDA rasterizer
(diff-surfel-rasterization config.h and auxiliary.h).  The JAX package's
static buffer caps (``emission_cap``, ``pair_cap``, ``tile_cap``) and its
Pallas switches have no counterpart here: the port sizes every binning
buffer from the measured counts, and the tensors' device picks the blend
path (CUDA kernel or plain PyTorch).
"""
from __future__ import annotations

import dataclasses

TILE = 16  # BLOCK_X == BLOCK_Y == 16

# --- Blend constants ---
FILTER_SIZE = 0.7071067811865476  # 1/sqrt(2) screen-space low-pass radius
FILTER_INV_SQUARE = 1.0 / (FILTER_SIZE * FILTER_SIZE)  # == 2.0
ALPHA_CLIP = 0.99           # max per-splat alpha
ALPHA_CUTOFF = 1.0 / 255.0  # splats below this alpha are skipped
T_CUTOFF = 1e-4             # transmittance early-termination threshold
TRUNCATED_R = 3.0           # 3-sigma truncation radius
NEAR_PLANE = 0.2
FAR_PLANE = 100.0


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Configuration of the tiled rasterizer."""
    # Pairs per step of the plain tiled blend (the CUDA kernel stages its
    # own 256-pair shared-memory batches).
    chunk: int = 64
    # Bin a pair only when the splat's exact visibility circle touches
    # the tile's pixel-center rect (ops/binning.visibility_circles); the
    # cull is output-invariant.
    tile_circle_cull: bool = True
    depth_ratio: float = 1.0  # 1 => median ("surf") depth, 0 => expected
