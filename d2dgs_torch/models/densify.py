"""Densification statistics, densify/prune and opacity reset (counterpart
of d2dgs_tpu/models/densify.py, the reference's gaussian_model.py:415-486).

The screen-space gradient norm of every visible Gaussian is accumulated
per step (gaussian_model.py:484-486), with the observation count and the
largest screen radius.  The point set lives in a fixed capacity with an
``alive`` mask, slot for slot as in the JAX package: clones and split
children are written into free slots, the originals of splits are killed,
and the Adam moments of every written slot are zeroed.  Unlike the JAX
package, parameters, ``alive`` and moments are updated in place.

Selection rules (densify_and_prune, gaussian_model.py:430-486):
  clone : |grad| >= tau and max(scale) <= percent_dense * extent
  split : |grad| >= tau and max(scale)  > percent_dense * extent,
          2 children sampled in the splat plane, child scale = scale / 1.6;
          original pruned
  prune : opacity < min_opacity, or (when ``prune_big_ws``) screen radius
          > 20 px or max(scale) > 0.1 * extent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.quaternion import quat_to_rotmat
from .gaussians import GaussianParams

TRAINABLE = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity", "feature")


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor   # [C] accumulated view-space grad norms
    denom: torch.Tensor        # [C] observation counts
    max_radii2d: torch.Tensor  # [C]


def init_stats(capacity: int, device) -> DensifyStats:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyStats(z(), z(), z())


def add_stats(stats: DensifyStats, screen_grad: torch.Tensor,
              visible: torch.Tensor, radii: torch.Tensor) -> DensifyStats:
    """screen_grad: [C,2] gradient of the zero-valued screen probe (see
    render/renderer.py); accumulate its norm for visible Gaussians and
    track the largest screen radius (train_gui.py:389-391)."""
    g = torch.linalg.vector_norm(screen_grad, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, g, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(visible, radii, 0.0)))


def free_slot_lookup(alive: torch.Tensor):
    """inv[r] = index of the r-th free slot (C if none); and the number of
    free slots."""
    c = alive.shape[0]
    free = ~alive
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    inv = torch.full((c,), c, dtype=torch.int64, device=alive.device)
    inv[rank[free]] = torch.nonzero(free).flatten()
    return inv, torch.sum(free.to(torch.int64))


def _place(x: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor):
    """x[dest[i]] = rows[i] where dest[i] < len(x) (others dropped)."""
    ok = dest < x.shape[0]
    x[dest[ok]] = rows[ok]


@torch.no_grad()
def densify_and_prune(params: GaussianParams, mu: dict, nu: dict,
                      stats: DensifyStats, max_grad: float,
                      min_opacity: float, extent: float, prune_big_ws: bool,
                      percent_dense: float = 0.01,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
    """Clone, split and prune in place.  ``noise`` [2, C, 2]: the split
    children's standard-normal offsets in the splat plane, or drawn on the
    CPU from ``generator``.  Returns (stats reset to zero, info dict of
    0-d counts: clones, splits, pruned, overflow)."""
    c = params.capacity
    dev = params.xyz.device
    alive0 = params.alive.clone()
    alive = params.alive.clone()
    grads = torch.nan_to_num(torch.where(
        stats.denom > 0, stats.grad_accum / stats.denom, 0.0))
    std = params.get_scaling                                  # [C,2]
    scale_max = torch.amax(std, dim=-1)

    hot = alive & (grads >= max_grad)
    clone_mask = hot & (scale_max <= percent_dense * extent)
    split_mask = hot & (scale_max > percent_dense * extent)

    inv, num_free = free_slot_lookup(alive)
    n_clone = torch.cumsum(clone_mask.to(torch.int64), 0)
    clone_rank = torch.where(clone_mask, n_clone - 1, c)
    total_clones = n_clone[-1]
    n_split = torch.cumsum(split_mask.to(torch.int64), 0)
    split_rank = torch.where(split_mask, n_split - 1, c // 2)

    dest_clone = inv[torch.clamp(clone_rank, 0, c - 1)]
    dest_clone = torch.where(clone_mask & (clone_rank < num_free),
                             dest_clone, c)
    r1 = total_clones + 2 * split_rank
    r2 = r1 + 1
    both_fit = split_mask & (r2 < num_free)
    dest_s1 = torch.where(both_fit, inv[torch.clamp(r1, 0, c - 1)], c)
    dest_s2 = torch.where(both_fit, inv[torch.clamp(r2, 0, c - 1)], c)

    # split children: sampled in the splat's local (u, v, 0) frame
    if noise is None:
        noise = torch.randn((2, c, 2), generator=generator)
    noise = noise.to(dev, torch.float32) * std[None]
    plane = quat_to_rotmat(params.rotation)[:, :, :2]         # columns u, v
    offs = torch.einsum("nij,knj->kni", plane, noise)         # [2,C,3]
    child_xyz = params.xyz[None] + offs
    child_scaling = params.scaling - torch.log(
        torch.tensor(0.8 * 2.0, device=dev))

    # clone destinations are free slots and split sources live ones, so the
    # writes below never read a row an earlier write changed
    for name in TRAINABLE:
        x = getattr(params, name)
        _place(x, dest_clone, x)
        for k, dest in enumerate((dest_s1, dest_s2)):
            row = {"xyz": child_xyz[k], "scaling": child_scaling}.get(name, x)
            _place(x, dest, row)
    for dest in (dest_clone, dest_s1, dest_s2):
        _place(alive, dest, torch.ones_like(alive))
    # kill split originals (only when their children were placed)
    alive &= ~both_fit
    # zero the Adam moments of every written slot (the reference's
    # optimizer surgery zeroes the extension rows)
    for moments in (mu, nu):
        for v in moments.values():
            for dest in (dest_clone, dest_s1, dest_s2):
                _place(v, dest, torch.zeros_like(v))

    # prune, with the densified opacities and scales; the screen-size test
    # reads the statistics before their reset
    opac = torch.sigmoid(params.opacity[:, 0])
    scale_max_new = torch.amax(torch.exp(params.scaling), dim=-1)
    prune = opac < min_opacity
    big = (stats.max_radii2d > 20.0) | (scale_max_new > 0.1 * extent)
    prune = prune | (big & bool(prune_big_ws))
    params.alive.copy_(alive & ~prune)

    overflow = (torch.sum(clone_mask & (dest_clone >= c))
                + torch.sum(split_mask & ~both_fit))
    info = dict(clones=torch.sum(dest_clone < c), splits=torch.sum(both_fit),
                pruned=torch.sum(alive0 & prune),
                overflow=overflow)
    return init_stats(c, dev), info


@torch.no_grad()
def reset_opacity(params: GaussianParams, mu: dict, nu: dict,
                  ceiling: float = 0.01):
    """Clamp opacity to at most ``ceiling`` and zero its Adam moments, in
    place (gaussian_model.py:251-254 and replace_tensor_to_optimizer)."""
    p = torch.clamp(torch.clamp_max(torch.sigmoid(params.opacity), ceiling),
                    1e-7, 1.0 - 1e-7)
    params.opacity.copy_(torch.log(p) - torch.log1p(-p))
    mu["opacity"].zero_()
    nu["opacity"].zero_()
