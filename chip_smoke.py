"""Smoke test of the PyTorch/CUDA port (``d2dgs_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):
  1. require CUDA, print the card's name and power limit, build the five
     CUDA sources from d2dgs_torch/csrc with nvcc and the native mesh
     library from native/mesh_post.cpp with g++ (one compiler per source,
     started together) and bind the kernels' eight entry points (K1 and K3
     in blend_fwd.cu, K2 and K4 in blend_bwd.cu, K5 and K6 in
     raster3d.cu, G2, the node warp's gather backward, in
     node_gather.cu, A1, Adam's update of a parameter group, in adam.cu);
  2. hold the forward kernel (K1: a first pass of one CTA per 64 pairs of
     a tile, then one CTA per 256-pair segment) in serving and in training
     mode against its plain PyTorch version on the card: a 48x64 scene of
     160 splats, the same scene all opaque (early termination), a packed
     48x64 scene of 700 splats (its busiest tile spans three 256-pair
     segments) and the full-width scene of phase 3; check the tiled CUDA
     render of the small scenes against the dense oracle;
  2b. hold the backward kernel (K2, one CTA per 256-pair segment of a
     tile, from K1's training checkpoints) against its plain version
     (autograd through the plain blend) on the same four scenes, with a
     seeded cotangent on the state rows the maps read; on the full-width
     view the cotangent is non-zero on the 16 heaviest tiles (up to 12
     segments each) and 48 seeded ones, and the plain version runs on
     those tiles alone;
  3. the served path at full width: 83,252 Gaussians from
     CONVERGENCE_r05_dist.npz at capacity 100,000, SH degree 3, 1024
     control nodes with the 8x256 deform MLP and its timenet, and four
     800x800 requests at t = 0, 0.25, 0.5, 0.75, each a node warp plus a
     render; checks finite outputs, coverage and one kernel launch per
     request, then times the kernel, its plain version and each render
     with CUDA events; a request launches no G2 and no A1;
  4. the training path at full width: the same scene with Adam state and
     densify statistics, trained for 10 main-stage steps at 800x800 and
     t = 0.5 towards the scene's own render, from a copy whose colours and
     opacities are perturbed from a seed, with every loss term on and the
     JAX trainer's LRs at iterations 8011-8020, after 10 steps at
     iterations 8001-8010 on the unperturbed scene have warmed the Adam
     moments (its parameters then put back); checks finite loss, moments
     and parameters, one K1 and one K2 launch, two G2 launches (the
     node warp's two gathers) and one A1 launch a parameter group (three)
     per counted step, the
     densify counts and a falling L1, holds estimate_rotation on the
     card (torch.linalg.svd there, as in every step's ARAP term) against
     numpy's float64 SVD on four ARAP graphs of the trained nodes, each
     vertex under the tests' bound (regularizers.rotation_rounding_bound),
     then times the step and its stages, K1 in training mode (with its
     checkpoints), K2 and K2's plain version, and prints the worst
     vertex's ratio to that bound and its s2 + s3, the tiles' walk
     lengths, each K2 work item's and each K1 pass's unit or item
     %globaltimer duration (the longest, the span), the counts, K1's
     first-pass evaluations, its scratch bytes and the checkpoint bytes;
  4b. hold G2 at node-train's shapes (200,000 x 3 rows into [1024, 13]
     and [1024, 18], the 116,748 dead rows piled on three nodes with a
     zero gradient) within 1e-6 of its plain version and of a float64
     sum, bitwise on a second call, and time it beside its bound, the
     plain version and aten's indexing backward
     (tools/node_gather_time.py);
  4c. hold A1 on the three groups at node-train's, hash-train's and
     mlp-train's shapes (200,000 slots; the node field, the hash field's
     twelve 2^19 x 2 tables, or the 8x256 MLP field): one step bitwise
     the plain version's, one launch a group, and time it beside its
     bound, the plain version and torch.optim.Adam's fused step
     (tools/adam_time.py);
  5a. hold the dense route's kernels, K3 (forward) and K4 (backward),
     against their plain versions on the three 48x64 scenes and on the
     full-width t=0.5 view, as phases 2 and 2b hold K1 and K2; run that
     view again at a tile_cap of half its busiest tile (K3 must equal K1 on
     the clamped lists, and both routes' overflow the dropped pairs), then
     time K3 (with its passes' units and items, as K1's), K4 (with its
     work items, as K2's), their plain versions, K4's zero fill and the
     dense pair gather;
  5b. the Trainer at full width on the dense route: a video of 8 orbit
     cameras x 4 times at 800x800 rendered from the phase-3 scene moved by
     the synthetic scene's rigid motion, a 100,000-point initial cloud,
     the JAX TrainConfig's defaults with only the schedule cut
     (SCHEDULE_5B): stage 1, the node downsampling and the main stage
     with densification, 99 iterations; checks finite losses, moments and
     parameters, one K3 and one K4 launch per training step and none of
     K1/K2, node_num node Gaussians after the downsampling and a rising
     stage-1 PSNR, then reports the mean step time of each stage;
  6. the user's entry points at full width: the phase-3 scene rendered
     (K1) from 8 orbit cameras x 4 times and 4 test views at 800x800 and
     written as a D-NeRF scene (RGBA PNGs, transforms_{train,test}.json),
     and as the CLI's own TrainState in a format-2 checkpoint (Adam's
     moments warmed on training views, colours and opacities perturbed);
     then, through d2dgs_torch.cli.main: render (the start's test
     metrics), train --resume for 40 main-stage steps with every loss
     term and the motion-mask term on (K1/K2), one test and one save
     iteration, render of the test split, mesh --max_times 1 at voxel
     0.004, and `python -m d2dgs_torch.cli render --mode time` as a
     subprocess; checks the files, the results.json keys, a test PSNR
     no lower than 1 dB under the start's, the PLY against the
     checkpoint's alive rows, a bitwise checkpoint round trip, a
     non-empty mesh, the native mesh library loaded, K1 and K2 launched
     and the dense route not; prints the step and view times, the TSDF
     grid and the mesh's times and size;
  7. the geometry path on the articulated figure at the widths of
     tools/convergence_torch.py (seed 0, 12 cameras x 8 times at
     800x800, 60,000 surfels, capacity 120,000, 1,024 nodes, the 8x256
     MLP): the ground-truth video (96 K1 renders: overflow 0, every image
     finite with a non-empty alpha); the ground-truth mesh at t = 0 (the
     static surfels fused from the t = 0 views at voxel 0.008) scored
     against the scene's exact surface: chamfer <= 0.045, and its
     render_mesh / mesh_shape_render covering the silhouette; the tool's
     --fast schedule (200 stage-1 and 600 main-stage iterations, K1/K2):
     finite losses and parameters, one K1 and one K2 launch per step,
     a test PSNR at least 3 dB over an empty render's; K1 against its
     plain version on the ground-truth view with the fullest tile
     (tile_cap 8192), and K1 and K2 against theirs on the last training
     step's own inputs and cotangent (tile_cap 2048), with the
     tolerances of phases 2-4; then `cli mesh
     --times 0.0 --voxel_size 0.008 --render_meshes` on the trained
     state: a non-empty PLY and mesh_image/0000.png and
     mesh_shape/0000.png each covering part of the silhouette; prints
     the ground truth's, a step's, the fusion's, the extraction's and
     the two mesh renders' times;
  8. the optical-flow training path at full width: phase 6's scene and
     start checkpoint with RAFT-format flow files written from the
     port's own render_flow of the unperturbed scene (one per training
     view, toward the same camera at the next time, the last time
     toward the one before; every fourth at 400x400, so load_flow
     resizes it); checks the flow term of the unperturbed scene against
     its own target (< 1e-6), rasterize_3dgs on the card (its blend
     through K5/K6) against the CPU (the plain walk) on a 16x16-tile crop
     (radii bitwise, image and alpha to 2e-5, depth to 2e-4, a pixel
     whose blended pair count differs judged by the threshold band and
     left out); K5 (two passes: 64-pair units, then (tile, 256-pair
     segment) items folded per tile) against blend3d_plain on the card
     over the whole view (T bitwise on tiles of one segment; a pixel that
     blends one pair more or less must lie within the threshold band of
     compare_blend3d; every other pixel T and colours to 2e-5, depth to
     2e-4, the same evaluated and blended counts) and K6 (one CTA per
     item) against the plain autograd VJP with a seeded cotangent (zero
     at the judged flips; each input max-normalised to GRAD); one
     Blend3D forward and backward under
     torch.cuda.set_sync_debug_mode("error"); that a main-stage step
     with a flow sample updates the deform MLP otherwise than one
     without, and K5 and K6 against their plain versions on that step's
     own inputs and flow-loss cotangent; then `cli train --resume` for 40
     main-stage steps (lambda_optical 0.1, the motion-mask term off): a
     flow sample in every step, one K1, K2, K5 and K6 launch per step,
     none of K3/K4 and no chunk of the plain walk, finite losses and a
     finite checkpoint; prints K5's and K6's times, bounds and plain
     times, their work items and units, pass A's evaluations, the share
     of (pair, warp) tests the cull refused, each unit's and item's
     %globaltimer duration, rasterize_3dgs's forward and
     forward-plus-backward times through
     the kernels and through the plain walk (in turns), a main-stage
     step's time with and without the flow term and their peak memory,
     and the CLI steps' times;
  9. (run after phase 6, before phase 8 adds flow files to its scene)
     the other deformation fields, DQB skinning and `cli edit` at full
     width on phase 6's scene: `cli train --deform_type hash` from the
     scene's initial cloud (the default TrainConfig and HashConfig:
     capacity 200,000, 12 levels of 2^19 entries; 60 steps, the field
     trained in the last 5, one test and one save iteration): no
     stage-1 step, one K1 and one K2 per step, a falling L1, a finite
     checkpoint, the tables of levels 7-11 bitwise their initial values
     and those of 0-5 moved (the band mask at step 60), then `cli
     render` and a non-empty `cli mesh --max_times 1`; K1 and K2 (on
     every tile) against their plain versions on the last hash step's
     own inputs and cotangent, K1's flips each judged by the threshold
     band (no done flip, none outside the band); `cli train --deform_type mlp` (20 steps)
     and `static` (10), one K1 and one K2 per step; the DQB warp of
     phase 3's scene (local-rotation and warp heads drawn from a seed)
     on the card against the CPU and four served 800x800 views, one K1
     each; `cli edit` on phase 6's trained node model (one handle at a
     node, a drag with an arc, 8 frames, 3 ARAP rounds): 8 PNGs and a
     GIF covering part of the view (where a node reaches no handle, the
     reference's singular step may leave a frame empty), handles and
     anchors within 1e-4 of their targets, finite solved nodes, the
     nodes the handles determine within 1e-3 of the CPU's solve, one K1
     per frame; prints each
     type's step time, hash_encode's forward and forward-plus-backward
     time on the hash step's rows, a served DQB view's and an edited
     frame's time and the ARAP solve's.
  10. (last) the sharded path of d2dgs_torch/parallel/ on the phase-3
     scene at t = 0.5: the tile exchange of 4 ranks emulated in one
     process (one card; NCCL takes no two ranks on one GPU): each shard's
     records, routed by indexing, each slab merged and blended through K1
     with the global-tile map, held against its plain version with the
     same map, the stitched slabs against the whole grid's K1 (bitwise
     but for the pixels of tiles that depth ties reorder, counted), K2
     with the map on the busiest slab against its plain VJP; the records
     and bytes per (source, destination) and the pair balance; then 10
     sharded main-stage steps through NCCL at world size 1, each from
     the state and with the draws of main_stage_step (loss to rtol
     2e-4, no overflow, one K1 and one K2 each), both timed; 8 SIBR
     viewer frames of phase 6's trained model over loopback through
     Trainer.attach_viewer (one K1 each, the last bitwise its direct
     render); and K1 and K2 of the whole grid timed without the map and
     with the identity map.
The line before the last two is the JSON record of the kernels, then the
card's name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "benchmark"))
# The published peaks of one H100 SXM (float32 outside the tensor cores,
# HBM) and the float32 operations per (pair, pixel) of csrc/blend_fwd.cu
# and csrc/blend_bwd.cu, as the benchmark's rooflines count them.
from benchlib.counts import (OPS_BLEND, OPS_BWD_BLEND,  # noqa: E402
                             OPS_EVAL, PEAK_BYTES_S, PEAK_F32_FLOPS)

# csrc/raster3d.cu at C = 3, float32 operations per (pair, pixel), counted
# from `pair_alpha` and the kernels' walks, of the pairs a sequential walk
# evaluates.  Every such pair costs the two offsets, the quadratic form's
# 9 and the cut's compare (12), all that a pair the cut refuses costs.  A
# pair with alpha > 0 (a blended one) adds expf counted as 1, the opacity
# product, the clip, the two cut tests and the alpha test (6); a pair
# refused after the cut (power > 0, or alpha below 1/255 inside the cut's
# margin) is counted at 12 too, so the bound stays below the work.  K5's
# blend: w, the 3 colour and the depth multiply-adds (8, no fma), 1 -
# alpha, T and the T test (12).  K6 re-walks every pair up to a pixel's
# last blended one; its blend adds the pre-blend T and w (3), the
# weight's adjoint (8), the colour and depth gradients (4), the alpha
# adjoint and the running sum (5), the clip and the opacity and power
# adjoints (4), the conic's (9) and the centre's (8) gradients, and its
# 10 gradients join the warp's sum (10): 51.
OPS_EVAL_3D, OPS_KEPT_3D = 12, 6
OPS_BLEND_3D, OPS_BWD_BLEND_3D = 12, 51

# kernel-vs-plain tolerances per state row: d2dgs_torch.ops.cuda.blend
# TIGHT and AUX, judged by its compare_states
MAX_FLIP_SHARE = 1e-4     # pixels whose termination/median branch flips
# K2 vs its plain version, each feature column max-normalised: the
# tolerance of the JAX package's kernel gradients (tests/test_pallas_blend.py)
GRAD = (2e-4, 2e-5)


def log(msg):
    print(msg, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SMALL_SCENES = ("48x64", "48x64 opaque", "48x64 packed")


def small_scene(label: str):
    """The 48x64 check scene of ``label`` (SMALL_SCENES):
    ``data/synthetic.blend_test_scene``, whose packed scene spans three
    backward segments."""
    from d2dgs_torch.data.synthetic import blend_test_scene
    kind = label.split()[1] if " " in label else "pallas"
    return blend_test_scene(kind)


def splat_inputs(means3d, scales, quats, opacity, colors, valid_mask, cam,
                 cfg):
    """The blend kernel's inputs for one view, as render() builds them."""
    from d2dgs_torch.ops.binning import bin_gaussians
    from d2dgs_torch.ops.projection import preprocess, tile_grid
    from d2dgs_torch.ops.tiled_raster import pack_features
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(means3d, scales, quats, cam)
    valid = prep.valid & valid_mask
    prep = prep._replace(valid=valid)
    opac = torch.where(valid, opacity, 0.0)
    binning = bin_gaussians(prep, gx, gy, cfg, opacity=opac)
    feats = pack_features(prep.T, prep.center, prep.normal, colors, opac)
    return feats[binning.order.long()].contiguous(), binning, gx


def check_states(tag, label, sk, sp, pairs, decisions=None):
    """Kernel state rows ``sk`` against the plain version's ``sp``: log the
    comparison and raise past the tolerances.  Without the plain walk's
    threshold-test rows ``decisions`` (phases 2, 5a and 7) the flips may
    number MAX_FLIP_SHARE of the pixels.  With them (compare_states) the
    band judges each flip: a done flip or one outside the band fails
    whatever the count, so the flips the band does not explain are held
    to none, below that cap."""
    from d2dgs_torch.ops.cuda.blend import compare_states
    res = compare_states(sk, sp, decisions)
    del res["masks"]
    band = "" if decisions is None else (
        f"; threshold band: {res['in_band']} in, {res['outside_band']} "
        f"outside; furthest {res['band_max_share']:.4g} of its band "
        f"({res['band_max_ulps']:.4g} ulps from the threshold after "
        f"{res['band_max_pairs']:.0f} pairs)")
    log(f"[{tag}] {label}: pairs {pairs}, flipped "
        f"pixels {res['flipped']}/{res['pixels']} (by kind "
        f"{json.dumps(res['flips'])}){band}, outside-tolerance "
        f"pixels beyond flips {res['bad_outside_flips']}, max |err| per row "
        + json.dumps({str(k): v for k, v in res['row_max_abs_err'].items()}))
    if decisions is None:
        unexplained = res["flipped"] > MAX_FLIP_SHARE * res["pixels"]
    else:
        unexplained = res["flips"]["done"] or res["outside_band"]
    if res["bad_outside_flips"] or unexplained:
        summary = {k: v for k, v in res.items() if k != "flip_mask"}
        raise AssertionError(f"blend kernel disagrees with its plain "
                             f"version on {label}: {summary}")
    return res


def train_buffers(counts):
    """A training forward's records buffer and segment layout."""
    from d2dgs_torch.ops.cuda.blend import NREC, segment_layout
    from d2dgs_torch.ops.tiled_raster import PIX
    records = torch.empty((counts.shape[0], NREC, PIX), dtype=torch.int32,
                          device=counts.device)
    return records, segment_layout(counts)


def check_kernel(label, feats_sorted, binning, gx, chunk, tag="phase 2",
                 gtile=None, band=False):
    """K1 in serving and in training mode against blend_tiles_plain (with
    the global-tile map ``gtile``, when given, on both sides); returns the
    serving state and its check, with the training mode's flip counts
    under ``training``.  ``band``: judge each flip by the threshold band
    (check_states with the plain walk's threshold-test rows)."""
    from d2dgs_torch.ops.cuda.blend import blend_fwd
    from d2dgs_torch.ops.tiled_raster import blend_tiles_plain
    args = (feats_sorted, binning.pair_rank, binning.tile_start,
            binning.tile_count, gx)
    sk = blend_fwd(*args, gtile=gtile)
    records, seg = train_buffers(binning.tile_count)
    st = blend_fwd(*args, records=records, segments=seg, gtile=gtile)
    torch.cuda.synchronize()
    sp = blend_tiles_plain(*args, chunk=chunk, tile_ids=gtile,
                           decisions=band)
    sp, dec = sp if band else (sp, None)
    torch.cuda.synchronize()
    pairs = int(binning.num_pairs)
    train = check_states(tag, label + ", training mode", st, sp, pairs, dec)
    res = check_states(tag, label, sk, sp, pairs, dec)
    res["training"] = {k: train[k] for k in ("flipped", "flips")}
    return sk, res


def map_cotangent(state: torch.Tensor, seed: int) -> torch.Tensor:
    """A cotangent from a seed on the state rows that state_to_maps reads
    (zero on K2's dead rows)."""
    from d2dgs_torch.ops.cuda.blend import DEAD_ROWS
    gen = torch.Generator(device=state.device).manual_seed(seed)
    g = torch.randn(state.shape, generator=gen, device=state.device)
    g[:, list(DEAD_ROWS)] = 0.0
    return g


def check_backward(label, feats_sorted, binning, gx, chunk, flip,
                   tiles=None, g=None, tag="phase 2b", batch=None,
                   gtile=None, judged=False):
    """K2 vs its plain version on one scene: a cotangent on the map rows
    (``g``, or one drawn from a seed), zero at the pixels whose
    termination or median flipped between K1 and the plain forward
    (``flip`` [T, PIX]) and, with ``tiles``, outside those tiles; all 18
    feature gradients compared max-normalised per column.  With
    ``batch`` (and no ``tiles``) the plain version runs over every tile,
    ``batch`` tiles of similar pair counts at a time (a pair's row is one
    tile's, so the batches' gradients add up to the view's).  ``gtile``:
    the global-tile map of both sides.  ``judged``: K1's check judged
    each flip by the threshold band (check_grads)."""
    from d2dgs_torch.ops.cuda.blend import (blend_bwd, blend_fwd,
                                            blend_tiles_plain_vjp)
    from d2dgs_torch.ops.tiled_raster import PIX
    args = (feats_sorted, binning.pair_rank, binning.tile_start,
            binning.tile_count, gx)
    num_tiles = binning.tile_start.shape[0]
    records, seg = train_buffers(binning.tile_count)
    state = blend_fwd(*args, records=records, segments=seg, gtile=gtile)
    g = map_cotangent(state, seed=4) if g is None else g
    g = torch.where(flip[:, None, :], 0.0, g)
    if tiles is not None:
        keep = torch.zeros(num_tiles, dtype=torch.bool, device=g.device)
        keep[tiles] = True
        g = torch.where(keep[:, None, None], g, 0.0)
    dk = blend_bwd(*args, state, records, g, seg, gtile=gtile)
    torch.cuda.synchronize()
    if batch and tiles is None:
        order = torch.argsort(binning.tile_count, descending=True)
        dp = sum(blend_tiles_plain_vjp(
            *args, g, tiles=torch.sort(order[b0:b0 + batch]).values,
            chunk=chunk, gtile=gtile) for b0 in range(0, num_tiles, batch))
    else:
        dp = blend_tiles_plain_vjp(*args, g, tiles=tiles, chunk=chunk,
                                   gtile=gtile)
    torch.cuda.synchronize()
    n_flip = int(flip[tiles].sum()) if tiles is not None else int(flip.sum())
    n_pix = (len(tiles) if tiles is not None else num_tiles) * PIX
    return check_grads(tag, label, dk, dp, n_flip, n_pix, judged)


def check_grads(tag, label, dk, dp, n_flip, n_pix, judged=False):
    """Kernel feature gradients ``dk`` against the plain version's ``dp``
    (rows of NFEAT), each column max-normalised; raise past GRAD, or when
    the excluded flipped pixels pass MAX_FLIP_SHARE of ``n_pix`` unless
    K1's check has ``judged`` each of them a threshold case of the band
    (check_states with the plain walk's threshold-test rows)."""
    dk, dp = dk.reshape(-1, dk.shape[-1]), dp.reshape(-1, dp.shape[-1])
    scale = dp.abs().amax(dim=0) + 1e-30
    err = (dk - dp).abs() / scale
    rtol, atol = GRAD
    bad = int((err > atol + rtol * dp.abs() / scale).sum())
    max_err = float(err.max())
    log(f"[{tag}] {label}: flipped pixels excluded {n_flip}/{n_pix}, "
        f"max normalised |err| {max_err:.3g} (per column "
        + json.dumps([round(float(e), 9) for e in err.amax(dim=0)])
        + f"), entries outside rtol {rtol} atol {atol}: {bad}")
    if bad or (not judged and n_flip > MAX_FLIP_SHARE * n_pix) or \
            not bool(torch.isfinite(dk).all()):
        raise AssertionError(f"backward kernel disagrees with its plain "
                             f"version on {label}")
    return {"max_norm_err": max_err, "flipped": n_flip, "pixels": n_pix,
            "max_abs_err": float((dk - dp).abs().max())}


@contextlib.contextmanager
def kernel_inputs(name: str, keep, module: str = "blend"):
    """Inside the block, each call of the wrapper ``name`` of
    ops/cuda/<module>.py (``blend_fwd`` or ``blend_bwd`` of blend.py,
    ``blend3d_bwd`` of raster3d.py) first hands its arguments to
    ``keep(args, kwargs)``; its launch count is unchanged."""
    import importlib
    blend_lib = importlib.import_module(f"d2dgs_torch.ops.cuda.{module}")
    real = getattr(blend_lib, name)

    def spy(*args, **kwargs):
        keep(args, kwargs)
        return real(*args, **kwargs)
    # the wrapper counts its launch on the module's name for it, the spy
    # while the block runs
    spy.launches = real.launches
    setattr(blend_lib, name, spy)
    try:
        yield
    finally:
        real.launches = spy.launches
        setattr(blend_lib, name, real)


def heavy_and_random_tiles(tile_count: torch.Tensor, n_heavy: int,
                           n_random: int, seed: int) -> torch.Tensor:
    """The ``n_heavy`` tiles with the most pairs and ``n_random`` others
    drawn from a seed, sorted."""
    heavy = torch.topk(tile_count, n_heavy).indices
    rest = torch.ones_like(tile_count, dtype=torch.bool)
    rest[heavy] = False
    others = torch.nonzero(rest).flatten()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pick = torch.randperm(others.numel(), generator=gen)[:n_random]
    return torch.sort(torch.cat([heavy, others[pick.to(others.device)]]))\
        .values


def plain_vjp_all_tiles_ms(feats_sorted, binning, gx, g, chunk,
                           batch: int = 64) -> float:
    """CUDA-event time of K2's plain version over every tile, run in
    batches of ``batch`` tiles of similar pair counts (the whole view at
    once would save every chunk's intermediates for all tiles)."""
    from d2dgs_torch.ops.cuda.blend import blend_tiles_plain_vjp
    order = torch.argsort(binning.tile_count, descending=True)
    total = 0.0
    for b0 in range(0, order.numel(), batch):
        tiles = order[b0:b0 + batch]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        blend_tiles_plain_vjp(feats_sorted, binning.pair_rank,
                              binning.tile_start, binning.tile_count, gx, g,
                              tiles=tiles, chunk=chunk)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total


def full_scene(dev):
    """83,252 converged Gaussians at capacity 100,000 and 1024 nodes."""
    from d2dgs_torch.models.deform import DeformConfig
    from d2dgs_torch.models.deform_mlp import MLPConfig
    from d2dgs_torch.models.gaussians import create_from_pcd
    from d2dgs_torch.models.nodes import (NodeConfig, init_node_params,
                                          init_nodes_from_pcl)
    with np.load(ROOT / "CONVERGENCE_r05_dist.npz") as z:
        xyz, scaling, opacity = z["xyz"], z["scaling"], z["opacity"]
    n = xyz.shape[0]
    rgb = np.random.RandomState(1).uniform(size=(n, 3)).astype(np.float32)
    rest = 0.05 * np.random.RandomState(2).normal(size=(n, 15, 3))
    gauss = create_from_pcd(xyz, rgb, capacity=100_000, sh_degree=3,
                            fea_dim=8, device=dev)
    with torch.no_grad():
        gauss.scaling[:n] = torch.as_tensor(scaling, device=dev)
        gauss.opacity[:n] = torch.as_tensor(opacity, device=dev)
        gauss.features_rest[:n] = torch.as_tensor(rest, dtype=torch.float32,
                                                  device=dev)
    gauss.active_sh_degree = 3
    # the JAX package's TrainConfig defaults: 1024 nodes, K=3, hyper_dim 8,
    # blender timenet, local frames
    node_cfg = NodeConfig(node_num=1024, K=3, hyper_dim=8,
                          mlp=MLPConfig(is_blender=True, local_frame=True))
    gen = torch.Generator().manual_seed(0)
    nodes = init_node_params(node_cfg, gen, device=dev)
    init_nodes_from_pcl(nodes, node_cfg, torch.as_tensor(xyz), generator=gen)
    return gauss, nodes, DeformConfig(deform_type="node", node=node_cfg)


def training_state(gauss, nodes, seed: int):
    """The phase-3 scene as a TrainState: zero Adam moments, empty densify
    statistics (the parts init_train_state adds to a point cloud)."""
    from d2dgs_torch.models.densify import init_stats
    from d2dgs_torch.train.optim import adam_init
    from d2dgs_torch.train.trainer import (TrainState, gauss_trainable,
                                           mlp_trainable, node_trainable)
    return TrainState(
        gauss=gauss, gauss_opt=adam_init(gauss_trainable(gauss)),
        gauss_stats=init_stats(gauss.capacity, gauss.xyz.device),
        nodes=nodes, node_opt=adam_init(node_trainable(nodes)),
        mlp_opt=adam_init(mlp_trainable(nodes)),
        generator=torch.Generator().manual_seed(seed))


# phase 4 warms the Adam moments with this many steps on the unperturbed
# scene before its counted steps (see warm_moments)
WARM_STEPS = 10


def scene_render(gauss, nodes, deform_cfg, cam, cfg) -> torch.Tensor:
    """The scene's own image at ``cam``: the node warp, then the render."""
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.render.renderer import render
    with torch.no_grad():
        d = deform_gaussians(nodes, deform_cfg, gauss.xyz, cam.time,
                             feature=gauss.feature,
                             motion_mask=gauss.motion_mask)
        return render(cam, gauss, torch.zeros(3, device=gauss.xyz.device),
                      d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=d["d_scaling"], cfg=cfg).image


def perturb(gauss, seed: int):
    """Perturb the colours and opacities in place, from a seed."""
    with torch.no_grad():
        gen = torch.Generator(device=gauss.xyz.device).manual_seed(seed)
        for p, s in ((gauss.features_dc, 0.6), (gauss.opacity, 1.0)):
            p.add_(s * torch.randn(p.shape, generator=gen, device=p.device))


def phase4_schedules(tcfg, n: int) -> list:
    """The JAX trainer's LRs at the ``n`` iterations from the first where
    the warm-up is over and the normal and distortion terms are on
    (iteration > normal_dist_from_iter, trainer.py:842-853)."""
    from d2dgs_torch.train.trainer import make_schedules
    xyz_sched, deform_sched = make_schedules(tcfg)
    its = range(tcfg.normal_dist_from_iter + 1,
                tcfg.normal_dist_from_iter + 1 + n)
    return [dict(warm=0.0, lambda_normal=0.05, lambda_dist=1000.0,
                 lambda_arap=0.01, xyz_lr=xyz_sched(it),
                 deform_lr=deform_sched(it), step=it) for it in its]


def warm_moments(state, cam, gt, tcfg, scheds):
    """Adam's moments as they are where such a step runs: the steps of
    ``scheds`` on the scene as it stands, towards ``gt``, then its
    parameters put back and the densify statistics emptied.  From zero
    moments a first Adam step moves every parameter by its whole LR."""
    from d2dgs_torch.models.densify import init_stats
    from d2dgs_torch.train.trainer import (gauss_trainable, main_stage_step,
                                           mlp_trainable, node_trainable)
    params = lambda: {**{("g", k): v for k, v in
                         gauss_trainable(state.gauss).items()},
                      **{("m", k): v for k, v in
                         mlp_trainable(state.nodes).items()},
                      **{("n", k): v for k, v in
                         node_trainable(state.nodes).items()}}
    keep = {k: v.detach().clone() for k, v in params().items()}
    for sched in scheds:
        state, _ = main_stage_step(state, cam, gt, tcfg, sched)
    with torch.no_grad():
        for k, v in params().items():
            v.copy_(keep[k])
    return state._replace(gauss_stats=init_stats(state.gauss.capacity,
                                                 state.gauss.xyz.device))


def check_trained(state, metrics, step):
    """Finite loss, moments and parameters after one step."""
    from d2dgs_torch.train.trainer import (gauss_trainable, mlp_trainable,
                                           node_trainable)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"step {step}: loss {metrics['loss']}")
    for name, params, opt in (
            ("gauss", gauss_trainable(state.gauss), state.gauss_opt),
            ("mlp", mlp_trainable(state.nodes), state.mlp_opt),
            ("node", node_trainable(state.nodes), state.node_opt)):
        for k, p in params.items():
            # mu = 0.9 mu + 0.1 g: a non-finite gradient shows in mu and nu
            for what, t in (("param", p), ("mu", opt.mu[k]),
                            ("nu", opt.nu[k])):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"step {step}: non-finite {what} "
                                         f"of {name}.{k}")


def check_card_rotations(nodes, node_cfg, n_draws: int = 4) -> dict:
    """``estimate_rotation`` on the card (``torch.linalg.svd`` there, as in
    the ARAP term of every training step) on the ARAP graphs of
    ``n_draws`` seeded draws over ``nodes``, each vertex held against
    numpy's float64 SVD of its float64 S under the tests' per-vertex bound
    (``regularizers.rotation_rounding_bound`` at its default c)."""
    from d2dgs_torch.models import regularizers as R
    gen = torch.Generator().manual_seed(11)
    errs, tols, sigs = [], [], []
    for _ in range(n_draws):
        draws = R.arap_draws(gen, nodes.nodes.shape[0])
        with torch.no_grad():
            seq, nn_idx, weight, _ = R.arap_graph(nodes, node_cfg, draws)
            rot = R.estimate_rotation(seq[0], seq[1], nn_idx, weight)
        S = R.procrustes_covariance64(seq[0], seq[1], nn_idx, weight)
        errs.append(np.abs(rot.cpu().double().numpy()
                           - R.rotation_oracle(S)).max(axis=(1, 2)))
        tols.append(R.rotation_rounding_bound(S))
        sigs.append(np.linalg.svd(S, compute_uv=False))
    err, tol, sig = (np.concatenate(a) for a in (errs, tols, sigs))
    ratio = err / tol
    m = int(np.argmax(ratio))
    res = dict(vertices=int(err.size), c=R.ROTATION_ROUNDING_C,
               worst_ratio=float(ratio[m]), worst_err=float(err[m]),
               worst_bound=float(tol[m]), worst_sigma=sig[m].tolist(),
               worst_s2_plus_s3=float(sig[m, 1] + sig[m, 2]),
               max_err=float(err.max()),
               above_floor=int((tol > 1e-5).sum()),
               undetermined=int(np.isinf(tol).sum()))
    if not ratio[m] <= 1.0:
        raise AssertionError(f"estimate_rotation on the card: {res}")
    return res


def step_stage_ms(fwd_stages: dict, full_loss, groups, extra_inputs,
                  reps: int) -> dict:
    """CUDA-event times of the forward stages ``fwd_stages`` (name -> fn,
    each run alone), of the backward of ``full_loss()`` in the groups'
    parameters and ``extra_inputs``, and of Adam on copies of the groups
    (so the timing does not move the model)."""
    from d2dgs_torch.train.optim import adam_init, adam_update
    inputs = [p for grp in groups for p in grp.values()] + extra_inputs
    back = []
    for _ in range(reps + 1):
        loss = full_loss()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(loss, inputs, allow_unused=True)
        end.record()
        torch.cuda.synchronize()
        back.append(start.elapsed_time(end))
    copies = [{k: p.detach().clone() for k, p in grp.items()}
              for grp in groups]
    opts = [adam_init(c) for c in copies]
    grads = [{k: torch.randn_like(p) for k, p in c.items()} for c in copies]

    def adam():
        for gr, o, c in zip(grads, opts, copies):
            adam_update(gr, o, c, 1e-3)

    res = {k: cuda_ms(fn, reps) for k, fn in fwd_stages.items()}
    res.update(backward=float(np.mean(back[1:])), adam=cuda_ms(adam, reps))
    return res


def train_stage_ms(state, cam, gt, cfg, sched, reps: int = 3) -> dict:
    """CUDA-event time of each stage of one main-stage step, run alone:
    warp forward, render forward, the losses, the backward, Adam."""
    from d2dgs_torch.models import regularizers as R
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.ops.ssim import l1, ssim
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train.trainer import (gauss_trainable, mlp_trainable,
                                           node_trainable, photometric_loss)
    g, nodes = state.gauss, state.nodes
    dev = g.xyz.device
    bg = torch.zeros(3, device=dev)
    probe = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
    draws = R.arap_draws(torch.Generator().manual_seed(7),
                         nodes.nodes.shape[0])

    def warp():
        return deform_gaussians(nodes, cfg.deform_cfg, g.xyz, cam.time,
                                feature=g.feature, motion_mask=g.motion_mask)

    d = warp()

    def fwd():
        return render(cam, g, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                      screen_probe=probe, cfg=cfg.raster)

    out = fwd()

    def losses():
        ll1 = l1(out.image, gt)
        loss = (1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * (
            1.0 - ssim(out.image, gt))
        loss = loss + sched["lambda_normal"] * torch.mean(
            1.0 - torch.sum(out.rend_normal * out.surf_normal, dim=-1))
        loss = loss + sched["lambda_dist"] * torch.mean(out.rend_dist)
        return loss + sched["lambda_arap"] * R.arap_loss(
            nodes, cfg.node_cfg, draws)

    def full_loss():
        return photometric_loss(g, nodes, cam, gt, probe, cfg, sched, bg)[0] \
            + sched["lambda_arap"] * R.arap_loss(nodes, cfg.node_cfg, draws)

    groups = [gauss_trainable(g), mlp_trainable(nodes), node_trainable(nodes)]
    return step_stage_ms({"warp_fwd": warp, "render_fwd": fwd,
                          "losses": losses}, full_loss, groups, [probe], reps)


def node_stage_ms(state, cam, gt, cfg, sched, reps: int = 3) -> dict:
    """The same for one stage-1 step (node_stage_step): the MLP warp of the
    node Gaussians, their render, the photometric losses, the elastic,
    acceleration and ARAP terms, the backward, Adam."""
    from d2dgs_torch.models import regularizers as R
    from d2dgs_torch.models.deform_mlp import mlp_forward
    from d2dgs_torch.ops.ssim import l1, ssim
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train.trainer import (gauss_trainable, mlp_trainable,
                                           node_trainable)
    ng, nodes, ncfg = state.ngauss, state.nodes, cfg.node_cfg
    dev = ng.xyz.device
    bg = torch.zeros(3, device=dev)
    probe = torch.zeros((ng.capacity, 2), device=dev, requires_grad=True)
    gen = torch.Generator().manual_seed(7)
    arap_d = R.arap_draws(gen, nodes.nodes.shape[0])
    elastic_d, acc_d = R.time_draws(gen, 8), R.time_draws(gen)
    t = cam.time.reshape(1, 1).expand(ng.capacity, 1)
    dt = sched["time_interval"]

    def warp():
        return mlp_forward(nodes.mlp, ncfg.mlp, ng.xyz.detach(),
                           t)["d_xyz"] * ng.motion_mask

    d = warp()

    def fwd(d_xyz=d):
        return render(cam, ng, bg, d_xyz=d_xyz, screen_probe=probe,
                      cfg=cfg.raster)

    out = fwd()

    def photometric(o=out):
        return (1.0 - cfg.lambda_dssim) * l1(o.image, gt) \
            + cfg.lambda_dssim * (1.0 - ssim(o.image, gt))

    def regularizers():
        return (cfg.lambda_elastic * R.elastic_loss(
                    nodes, ncfg, elastic_d, t=cam.time, delta_t=dt)
                + cfg.lambda_acc * R.acc_loss(nodes, ncfg, acc_d, t=cam.time,
                                              delta_t=3.0 * dt)
                + cfg.lambda_node_arap * R.arap_loss(nodes, ncfg, arap_d))

    groups = [gauss_trainable(ng), mlp_trainable(nodes), node_trainable(nodes)]
    return step_stage_ms(
        {"warp_fwd": warp, "render_fwd": fwd, "photometric": photometric,
         "regularizers": regularizers},
        lambda: photometric(fwd(warp())) + regularizers(), groups, [probe],
        reps)


def fwd_bound(state, in_bytes: int) -> dict:
    """Least time of a blend forward (K1 or K3): float32 operations of the
    pairs each pixel evaluated and blended (state rows 14 and 15), against
    ``in_bytes`` read once plus the state rows written once."""
    from d2dgs_torch.ops.tiled_raster import ROW_N_BLEND, ROW_N_EVAL
    n_eval = float(state[:, ROW_N_EVAL].to(torch.float64).sum())
    n_blend = float(state[:, ROW_N_BLEND].to(torch.float64).sum())
    ops = OPS_EVAL * n_eval + OPS_BLEND * n_blend
    nbytes = in_bytes + state.numel() * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"n_eval": n_eval, "n_blend": n_blend, "ops": ops,
            "bytes": nbytes, "t_ops": t_ops, "t_bytes": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bwd_bound(state, records, in_bytes: int, out_bytes: int,
              n_reduce: int) -> dict:
    """Least time of a blend backward (K2 or K4): float32 operations of
    the pairs each pixel walks and blends, against the feature bytes read
    (``in_bytes``) and the gradient bytes written (``out_bytes``) once,
    the state, records and cotangent rows read per pixel, and the global
    atomics of ``n_reduce`` warp sums, NFEAT each (K2's; K4 stores each
    row once, inside ``out_bytes``, so it passes 0)."""
    from d2dgs_torch.ops.cuda.blend import REC_LAST
    from d2dgs_torch.ops.tiled_raster import NFEAT, PIX, ROW_N_BLEND
    n_eval = float((records[:, REC_LAST].to(torch.float64) + 1.0).sum())
    n_blend = float(state[:, ROW_N_BLEND].to(torch.float64).sum())
    ops = OPS_EVAL * n_eval + OPS_BWD_BLEND * n_blend
    num_tiles = state.shape[0]
    nbytes = (in_bytes + out_bytes + num_tiles * PIX * 4 * (3 + 2 + 11)
              + n_reduce * NFEAT * 4)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"n_eval": n_eval, "n_blend": n_blend, "ops": ops,
            "bytes": nbytes, "n_reduce": n_reduce, "t_ops": t_ops,
            "t_bytes": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k2_bound(fs, binning, state, records, n_reduce: int):
    """K2's bound: sorted features in and their gradients out once, the
    pair ranks and tile starts."""
    return bwd_bound(state, records,
                     fs.numel() * 4 + binning.pair_rank.numel() * 4
                     + state.shape[0] * 4, fs.numel() * 4, n_reduce)


WALK_BINS = (0, 1, 65, 129, 257, 513, 1025, 2049, 4097)


def walk_histogram(records) -> dict:
    """Tiles per range of walk length (the tile's slowest pixel's last
    blended pair + 1, the pairs a back-to-front walk covers)."""
    from d2dgs_torch.ops.cuda.blend import REC_LAST
    n_walk = records[:, REC_LAST].amax(dim=1).to(torch.int64) + 1
    edges = torch.tensor(WALK_BINS, device=n_walk.device)
    idx = torch.bucketize(n_walk, edges, right=True) - 1
    counts = torch.bincount(idx, minlength=len(WALK_BINS)).tolist()
    names = ["0"] + [f"{a}-{b - 1}" for a, b in zip(WALK_BINS[1:],
                                                     WALK_BINS[2:])] \
        + [f">={WALK_BINS[-1]}"]
    return {n: c for n, c in zip(names, counts[:len(names)]) if c}


def item_walks(records, segments):
    """The pairs each backward work item walks: its segment's share of
    its tile's walk length."""
    from d2dgs_torch.ops.cuda.blend import REC_LAST, SEG
    n_walk = records[:, REC_LAST].amax(dim=1).to(torch.int64) + 1
    t, s = segments.items.long().unbind(1)
    return torch.clamp(n_walk[t] - s * SEG, 0, SEG)


def fwd_walks(state):
    """The pairs the walk of each tile covers: its slowest pixel's
    evaluations (state row 14), up to and with its termination."""
    from d2dgs_torch.ops.tiled_raster import ROW_N_EVAL
    return state[:, ROW_N_EVAL].amax(dim=1).to(torch.int64)


def fwd_item_report(tag, label, run, state, counts) -> dict:
    """Both passes of a serving forward (K1 or K3) timed per work unit:
    ``run(**kw)`` launches it with the keywords given; ``state`` its
    state rows, ``counts`` the clamped pair counts.  A first launch
    reports its grids, the second is timed: the first pass runs one CTA
    per UNIT pairs of a tile, the second one per (tile, SEG-pair segment)
    item, which walks its share of the tile's walk.  The units and items
    are read back from the layout the timed launch built on the card
    (forward_layout), whose items must be the backward's
    (segment_layout).  Logs and returns each pass's item_report, the
    forward's span and longest unit or item, the first pass's pair-pixel
    evaluations beside the walk's (state row 14), the grids and the bytes
    of each scratch buffer the launch allocated."""
    from d2dgs_torch.ops.cuda.blend import (SEG, UNIT, forward_layout,
                                            segment_layout)
    from d2dgs_torch.ops.tiled_raster import ROW_N_EVAL
    dev = state.device
    grids, rep = {}, {}
    run(report=grids)
    unit_ns = torch.zeros((grids["grid_units"], 2), dtype=torch.int64,
                          device=dev)
    item_ns = torch.zeros((grids["grid_items"], 2), dtype=torch.int64,
                          device=dev)
    n_pass_a = torch.zeros(1, dtype=torch.int64, device=dev)
    run(unit_ns=unit_ns, item_ns=item_ns, n_pass_a=n_pass_a, report=rep)
    torch.cuda.synchronize()
    items, units = forward_layout(rep)
    if not torch.equal(items, segment_layout(counts).items):
        raise AssertionError(f"{label}: the forward's work items are not "
                             f"the backward's segment_layout items")
    unit_ns, item_ns = unit_ns[:units.shape[0]], item_ns[:items.shape[0]]
    c = counts.long()
    t, s = items.long().unbind(1)
    unit_tile, unit_k = units.long().unbind(1)
    walk_b = torch.clamp(fwd_walks(state)[t] - s * SEG, 0, SEG)
    rep_a = item_report(tag, f"{label} pass A", unit_ns, unit_tile,
                        torch.clamp(c[unit_tile] - unit_k * UNIT, 0, UNIT),
                        counts)
    rep_b = item_report(tag, f"{label} pass B", item_ns, t, walk_b, counts)
    res = {"items": int(items.shape[0]), "units": int(units.shape[0]),
           "grid_items": rep["grid_items"], "grid_units": rep["grid_units"],
           "pass_a": rep_a, "pass_b": rep_b,
           "span_us": float(item_ns[:, 1].max() - unit_ns[:, 0].min())
           / 1e3,
           "longest_us": max(rep_a["slowest_us"], rep_b["slowest_us"]),
           "pass_a_evals": int(n_pass_a),
           "walk_evals": float(state[:, ROW_N_EVAL].to(torch.float64).sum()),
           "scratch_bytes": rep["scratch_bytes"],
           "partial_bytes": sum(rep["scratch_bytes"].values())}
    log(f"[{tag}] {label} forward: {res['units']} units (grid "
        f"{res['grid_units']}) and {res['items']} work items (grid "
        f"{res['grid_items']}), read from the card's layout; span "
        f"{res['span_us']:.1f} us (pass A {rep_a['span_us']:.1f}, pass B "
        f"{rep_b['span_us']:.1f}), longest {res['longest_us']:.1f} us; pass "
        f"A evaluations {res['pass_a_evals']} beside the walk's "
        f"{res['walk_evals']:.0f}; scratch allocated {res['partial_bytes']} "
        f"B " + json.dumps(res["scratch_bytes"]))
    return res


def item_report(tag, label, item_ns, item_tile, item_walk, tile_count):
    """The per-work-item timer of a backward launch: [I, 2] int64
    %globaltimer stamps at each item's start and end; ``item_tile`` and
    ``item_walk`` give each item's tile and the pairs it walked."""
    dur = (item_ns[:, 1] - item_ns[:, 0]).to(torch.float64) / 1e3   # us
    span = float(item_ns[:, 1].max() - item_ns[:, 0].min()) / 1e3
    top = torch.topk(dur, min(5, dur.numel()))
    slow = [{"us": round(float(d), 3), "tile": int(item_tile[i]),
             "pairs": int(tile_count[item_tile[i]]),
             "walk": int(item_walk[i]),
             "start_us": round(float(item_ns[i, 0] - item_ns[:, 0].min())
                               / 1e3, 3)}
            for d, i in zip(top.values.tolist(), top.indices.tolist())]
    walked = item_walk > 0
    res = {"items": int(dur.numel()), "span_us": span,
           "slowest_us": float(top.values[0]), "slowest": slow,
           "mean_us": float(dur[walked].mean()) if bool(walked.any())
           else 0.0,
           "sum_us": float(dur.sum()),
           "us_per_walked_pair": float(dur[walked].sum()
                                       / item_walk[walked].sum())
           if bool(walked.any()) else 0.0}
    log(f"[{tag}] {label} work items: " + json.dumps(res))
    return res


def fwd_fields(rep) -> dict:
    """A forward kernel's work-item fields of the kernels line, from
    fwd_item_report."""
    return {"work_items": rep["items"], "pass_a_units": rep["units"],
            "grid_items": rep["grid_items"], "grid_units": rep["grid_units"],
            "longest_item_us": rep["longest_us"],
            "items_span_us": rep["span_us"],
            "partial_bytes": rep["partial_bytes"],
            "scratch_bytes": rep["scratch_bytes"],
            "partial_bytes_training": rep["train_partial_bytes"],
            "pass_a_span_us": rep["pass_a"]["span_us"],
            "pass_b_span_us": rep["pass_b"]["span_us"],
            "pass_a_longest_us": rep["pass_a"]["slowest_us"],
            "pass_b_longest_us": rep["pass_b"]["slowest_us"],
            "pass_a_evaluations": rep["pass_a_evals"]}


def flip_fields(checks: dict) -> dict:
    """A forward kernel's flips of the kernels line, from check_kernel or
    check_dense_kernel results by scene: each kind's count in serving and
    in training mode, and the moved terminations on their own."""
    kinds = {label: {"serving": r["flips"], "training": r["training"]["flips"]}
             for label, r in checks.items()}
    return {"flips_by_kind": kinds,
            "trip_moved_pixels": {label: {m: f["trip_moved"]
                                          for m, f in k.items()}
                                  for label, k in kinds.items()}}


def dense_inputs(feats_sorted, binning, tile_cap: int):
    """The dense route's (gdata, counts) for one view, from its depth-sorted
    features (build_gdata with the identity order)."""
    from d2dgs_torch.ops.cuda.blend_dense import build_gdata
    ident = torch.arange(feats_sorted.shape[0], dtype=torch.int32,
                         device=feats_sorted.device)
    return build_gdata(feats_sorted, binning._replace(order=ident), tile_cap)


def dense_row_bytes(counts) -> int:
    """Bytes of the gdata rows the dense kernels read: each tile's first
    counts[t] rows of 18 floats, and the counts."""
    from d2dgs_torch.ops.tiled_raster import NFEAT
    return int(counts.to(torch.int64).sum()) * NFEAT * 4 + counts.numel() * 4


def check_dense_kernel(label, gdata, counts, gx, chunk, max_pairs):
    """K3 in serving and in training mode against blend_dense_plain on
    one view, its work sized from ``max_pairs`` (the binning's pair
    count) as the render path sizes it; returns as check_kernel."""
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_fwd,
                                                  blend_dense_plain)
    sk = blend_dense_fwd(gdata, counts, gx, max_pairs=max_pairs)
    records, seg = train_buffers(counts)
    st = blend_dense_fwd(gdata, counts, gx, records=records, segments=seg,
                         max_pairs=max_pairs)
    torch.cuda.synchronize()
    sp = blend_dense_plain(gdata, counts, gx, chunk=chunk)
    torch.cuda.synchronize()
    pairs = int(counts.to(torch.int64).sum())
    train = check_states("phase 5a", label + ", training mode", st, sp,
                         pairs)
    res = check_states("phase 5a", label, sk, sp, pairs)
    res["training"] = {k: train[k] for k in ("flipped", "flips")}
    return sk, res


def check_dense_backward(label, gdata, counts, gx, chunk, max_pairs, flip,
                         tiles=None):
    """K4 against blend_dense_plain_vjp, as check_backward holds K2: a
    seeded cotangent on the map rows, zero at the flipped pixels and, with
    ``tiles``, outside those tiles; K3's work sized as in
    check_dense_kernel."""
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_bwd,
                                                  blend_dense_fwd,
                                                  blend_dense_plain_vjp)
    from d2dgs_torch.ops.tiled_raster import PIX
    num_tiles = gdata.shape[0]
    records, seg = train_buffers(counts)
    state = blend_dense_fwd(gdata, counts, gx, records=records, segments=seg,
                            max_pairs=max_pairs)
    g = torch.where(flip[:, None, :], 0.0, map_cotangent(state, seed=4))
    if tiles is not None:
        keep = torch.zeros(num_tiles, dtype=torch.bool, device=g.device)
        keep[tiles] = True
        g = torch.where(keep[:, None, None], g, 0.0)
    dk = blend_dense_bwd(gdata, counts, gx, state, records, g, seg)
    torch.cuda.synchronize()
    dp = blend_dense_plain_vjp(gdata, counts, gx, g, tiles=tiles, chunk=chunk)
    torch.cuda.synchronize()
    past = torch.arange(gdata.shape[1], device=gdata.device)[None, :] \
        >= counts[:, None]
    if bool(dk[past].any()):
        raise AssertionError(f"K4 wrote gradients past the counts on {label}")
    if tiles is not None:
        dk, dp = dk[tiles], dp[tiles]
    n_flip = int(flip[tiles].sum()) if tiles is not None else int(flip.sum())
    n_pix = (len(tiles) if tiles is not None else num_tiles) * PIX
    return check_grads("phase 5a", label, dk, dp, n_flip, n_pix)


def plain_dense_vjp_all_tiles_ms(gdata, counts, gx, g, chunk,
                                 batch: int = 64) -> float:
    """CUDA-event time of K4's plain version over every tile, in batches of
    ``batch`` tiles of similar pair counts (as plain_vjp_all_tiles_ms)."""
    from d2dgs_torch.ops.cuda.blend_dense import blend_dense_plain_vjp
    order = torch.argsort(counts, descending=True)
    total = 0.0
    for b0 in range(0, order.numel(), batch):
        tiles = order[b0:b0 + batch]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        blend_dense_plain_vjp(gdata, counts, gx, g, tiles=tiles, chunk=chunk)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total


def kernel_wrappers() -> tuple:
    """The wrapper of each kernel, K1-K6, then G2 (the node warp's gather
    backward) and A1 (Adam's update of a parameter group), in that
    order."""
    from d2dgs_torch.ops.cuda.adam import adam_step
    from d2dgs_torch.ops.cuda.blend import blend_bwd, blend_fwd
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_bwd,
                                                  blend_dense_fwd)
    from d2dgs_torch.ops.cuda.node_gather import gather_bwd
    from d2dgs_torch.ops.cuda.raster3d import blend3d_bwd, blend3d_fwd
    return (blend_fwd, blend_bwd, blend_dense_fwd, blend_dense_bwd,
            blend3d_fwd, blend3d_bwd, gather_bwd, adam_step)


def launch_counts() -> dict:
    """Each kernel's launches since its counter was last reset."""
    return {f.__name__: f.launches for f in kernel_wrappers()}


def reset_counts():
    for f in kernel_wrappers():
        f.launches = 0


# G2 launches in a node step: the backward of cal_nn_weight's and warp's
# gathers; a view launches none (its forward is aten's indexing)
NODE_GATHERS = 2
# G2 against the plain version (index_add_ in float64, rounded once),
# relative to the gradient's norm, as tests/test_torch_cuda.py holds it
NODE_GATHER_REL = 1e-6


# A1 launches in a main-stage step: one a parameter group (the Gaussians,
# the deform field, the nodes), each of fewer than MAX_LEAVES leaves
ADAM_GROUPS = 3


def adam_check(dev, card) -> dict:
    """A1 on the three groups at node-train's, hash-train's and
    mlp-train's shapes (tools/adam_time.py, imported as a module): one step bitwise the
    plain version's, ADAM_GROUPS launches, and its time beside its bound,
    the plain version and torch.optim.Adam's fused step."""
    sys.path.insert(0, str(ROOT / "tools"))
    import adam_time
    res = adam_time.measure(dev)
    for r in res:
        if not r["bitwise_plain"] or r["launches_per_step"] != ADAM_GROUPS:
            raise AssertionError(f"A1 on the {r['field']} field: {r}")
        log(f"[phase 4c] A1 on the {r['field']} field's groups ({r['leaves']}"
            f" leaves, {r['elements']} elements): bitwise the plain "
            f"version, {r['launches_per_step']} launches, {r['ms']:.4f} ms "
            f"(host {r['host_ms']:.3f} ms), bound {r['bound_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms (host {r['plain_host_ms']:.3f} "
            f"ms), torch.optim.Adam fused {r['library_ms']:.4f} ms ({card})")
    return {"by_field": res}


def node_gather_check(dev, card) -> dict:
    """G2 at node-train's shapes (tools/node_gather_time.py, imported as a
    module): within NODE_GATHER_REL of its plain version and of a float64
    sum, the same bits on a second call, and its time beside its bound,
    the plain version and aten's indexing backward."""
    sys.path.insert(0, str(ROOT / "tools"))
    import node_gather_time
    res = node_gather_time.measure(dev)
    for r in res:
        if max(r["rel_err_plain"], r["rel_err_float64"]) > NODE_GATHER_REL \
                or not r["bitwise_repeat"]:
            raise AssertionError(f"G2 at {r['table']}: {r}")
        log(f"[phase 4b] G2 at {r['rows']} rows into {r['table']}: plan "
            f"{r['plan']}, error {r['rel_err_plain']:.3e} (plain) "
            f"{r['rel_err_float64']:.3e} (float64), bitwise repeat, "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, aten {r['library_ms']:.3f} ms ({card})")
    return {"by_width": res}


def phase_5a(cfg, cam_s, fs_t, bin_t, gx_t, card) -> dict:
    """K3 and K4 against their plain versions on the two 48x64 scenes and
    the full-width t=0.5 view, the view again at a tile_cap below its
    busiest tile, then their times beside their bounds and plain times."""
    from d2dgs_torch.ops.cuda.blend import NREC, blend_fwd, segment_layout
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_bwd,
                                                  blend_dense_fwd,
                                                  blend_dense_plain,
                                                  build_gdata)
    from d2dgs_torch.ops.tiled_raster import PIX
    dev = fs_t.device
    checks, grads = {}, {}
    for label in SMALL_SCENES:
        arrs = [torch.as_tensor(a, device=dev) for a in small_scene(label)]
        alive = torch.ones(arrs[0].shape[0], dtype=torch.bool, device=dev)
        fs, binning, gx = splat_inputs(*arrs, alive, cam_s, cfg)
        gdata, counts = dense_inputs(fs, binning, cfg.tile_cap)
        n_pairs = binning.pair_rank.shape[0]
        _, checks[label] = check_dense_kernel(label, gdata, counts, gx,
                                              cfg.chunk, n_pairs)
        grads[label] = check_dense_backward(label, gdata, counts, gx,
                                            cfg.chunk, n_pairs,
                                            checks[label].pop("flip_mask"))
    with torch.no_grad():
        gdata, counts = dense_inputs(fs_t, bin_t, cfg.tile_cap)
        n_pairs = bin_t.pair_rank.shape[0]
        label = "800x800 t=0.5"
        state_k3, checks[label] = check_dense_kernel(label, gdata, counts,
                                                     gx_t, cfg.chunk, n_pairs)
        tiles = heavy_and_random_tiles(bin_t.tile_count, 16, 48, seed=8)
        grads[label] = check_dense_backward(
            label + ", 16 heaviest + 48 seeded tiles", gdata, counts, gx_t,
            cfg.chunk, n_pairs, checks[label].pop("flip_mask"), tiles=tiles)

        # truncation on the card: half the busiest tile's pairs
        busiest = int(bin_t.tile_count.max())
        cap = busiest // 2
        g_cut, c_cut = dense_inputs(fs_t, bin_t, cap)
        label_cut = f"800x800 t=0.5, tile_cap {cap} < busiest {busiest}"
        s_cut, checks[label_cut] = check_dense_kernel(label_cut, g_cut, c_cut,
                                                      gx_t, cfg.chunk, n_pairs)
        checks[label_cut].pop("flip_mask")
        k1_cut = blend_fwd(fs_t, bin_t.pair_rank, bin_t.tile_start,
                           torch.clamp_max(bin_t.tile_count, cap), gx_t)
        if not torch.equal(k1_cut, s_cut):
            raise AssertionError("K3 and K1 differ on the same clamped "
                                 "pair lists")
        overflow = {}
        for wq in (False, True):
            c = dataclasses.replace(cfg, tile_cap=cap, use_workqueue=wq)
            overflow["wq" if wq else "dense"] = int(
                render_overflow(fs_t, bin_t, gx_t, c))
        dropped = int(torch.clamp_min(bin_t.tile_count - cap, 0).sum())
        log(f"[phase 5a] {label_cut}: overflow dense {overflow['dense']}, "
            f"work queue {overflow['wq']}, pairs past the cap {dropped}; K3 "
            f"equals K1 on the clamped lists bit for bit")
        if not overflow["dense"] == overflow["wq"] == dropped > 0:
            raise AssertionError(f"overflow {overflow} != {dropped}")
        del g_cut, c_cut, s_cut, k1_cut

        # times on the t=0.5 view: K3/K4 beside their bounds and plain
        # versions, and the dense layout's gather
        records = torch.empty((gdata.shape[0], NREC, PIX), dtype=torch.int32,
                              device=dev)
        seg = segment_layout(counts)
        train_rep = {}
        state = blend_dense_fwd(gdata, counts, gx_t, records=records,
                                segments=seg, max_pairs=n_pairs,
                                report=train_rep)
        g = map_cotangent(state, seed=9)
        n_reduce = torch.zeros(1, dtype=torch.int64, device=dev)
        blend_dense_bwd(gdata, counts, gx_t, state, records, g, seg,
                        n_reduce=n_reduce)
        item_ns = torch.zeros((seg.items.shape[0], 2), dtype=torch.int64,
                              device=dev)
        blend_dense_bwd(gdata, counts, gx_t, state, records, g, seg,
                        item_ns=item_ns)
        torch.cuda.synchronize()
        k4_items = item_report("phase 5a", "K4", item_ns, seg.items[:, 0],
                               item_walks(records, seg), counts)
        k3_items = fwd_item_report(
            "phase 5a", "K3", lambda **k: blend_dense_fwd(
                gdata, counts, gx_t, max_pairs=n_pairs, **k), state, counts)
        k3_items["train_partial_bytes"] = sum(
            train_rep["scratch_bytes"].values())
        k3_ms = cuda_ms(lambda: blend_dense_fwd(gdata, counts, gx_t,
                                                max_pairs=n_pairs), reps=20)
        k3_train_ms = cuda_ms(lambda: blend_dense_fwd(
            gdata, counts, gx_t, records=records, segments=seg,
            max_pairs=n_pairs), reps=20)
        k4_ms = cuda_ms(lambda: blend_dense_bwd(gdata, counts, gx_t, state,
                                                records, g, seg), reps=20)
        # the wrapper's zero fill of d_gdata, inside K4's time
        zero_ms = cuda_ms(lambda: torch.zeros_like(gdata), reps=20)
        k3_plain_ms = cuda_ms(lambda: blend_dense_plain(
            gdata, counts, gx_t, chunk=cfg.chunk), reps=3)
        k4_plain_ms = plain_dense_vjp_all_tiles_ms(gdata, counts, gx_t, g,
                                                   cfg.chunk)
        ident = torch.arange(fs_t.shape[0], dtype=torch.int32, device=dev)
        b_id = bin_t._replace(order=ident)
        gather_ms = cuda_ms(lambda: build_gdata(fs_t, b_id, cfg.tile_cap),
                            reps=5)
    f = fs_t.detach().requires_grad_()
    gd, _ = build_gdata(f, b_id, cfg.tile_cap)
    d_gdata = torch.randn_like(gd)
    back = []
    for _ in range(4):
        gd, _ = build_gdata(f, b_id, cfg.tile_cap)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(gd, f, d_gdata)
        end.record()
        torch.cuda.synchronize()
        back.append(start.elapsed_time(end))
    del gd, d_gdata, f
    row_bytes = dense_row_bytes(counts)
    b3 = fwd_bound(state, row_bytes)
    b4 = bwd_bound(state, records, row_bytes, gdata.numel() * 4, 0)
    res = {"k3_ms": k3_ms, "k3_train_ms": k3_train_ms, "k4_ms": k4_ms,
           "k3_plain_ms": k3_plain_ms, "k4_plain_ms": k4_plain_ms,
           "gather_ms": gather_ms, "gather_bwd_ms": float(np.mean(back[1:])),
           "gdata_bytes": gdata.numel() * 4, "k3_bound": b3, "k4_bound": b4,
           "k4_items": k4_items, "k3_items": k3_items,
           "ckpt_bytes": seg.ckpt.numel() * 4,
           "k4_zero_fill_ms": zero_ms,
           "checks": checks, "grads": grads,
           "k3_max_abs_err": checks[label]["max_abs_err"],
           "k4_max_abs_err": grads[label]["max_abs_err"]}
    log(f"[phase 5a] t=0.5 view ({card}): K3 {k3_ms:.4f} ms (training mode "
        f"{k3_train_ms:.4f}), bound {b3['bound_ms']:.4f} ms by "
        f"{b3['bound_by']} ({b3['ops']:.4g} ops, {b3['bytes']} B), plain "
        f"{k3_plain_ms:.1f} ms; K4 {k4_ms:.4f} ms, bound "
        f"{b4['bound_ms']:.4f} ms by {b4['bound_by']} ({b4['ops']:.4g} ops, "
        f"{b4['bytes']} B, {int(n_reduce)} warp sums), plain "
        f"{k4_plain_ms:.1f} ms (64-tile batches), zero fill of d_gdata "
        f"{zero_ms:.4f} ms, {k4_items['items']} work "
        f"items, longest {k4_items['slowest_us']:.1f} us, checkpoints "
        f"{seg.ckpt.numel() * 4} B; build_gdata "
        f"{gather_ms:.4f} ms, its transpose {res['gather_bwd_ms']:.4f} ms, "
        f"gdata {gdata.numel() * 4} B")
    return res


def render_overflow(fs_sorted, binning, gx, cfg):
    """blend_tiles' overflow count on one view's depth-sorted features."""
    from d2dgs_torch.ops.tiled_raster import blend_tiles
    ident = torch.arange(fs_sorted.shape[0], dtype=torch.int32,
                         device=fs_sorted.device)
    f = fs_sorted
    _, _, overflow = blend_tiles(
        f[:, 0:9].reshape(-1, 3, 3), f[:, 9:11], f[:, 11:14], f[:, 14:17],
        f[:, 17], binning._replace(order=ident), gx,
        binning.tile_start.shape[0] // gx, cfg)
    return overflow


# phase 5b: the JAX TrainConfig's defaults with only the schedule cut
SCHEDULE_5B = dict(node_warm_up=20, iterations_node_sampling=50,
                   iterations_node_rendering=60, densification_interval=10,
                   densify_from_iter=5, opacity_reset_interval=40,
                   warm_up=10, iterations=40, oneup_sh_degree_step=10,
                   normal_dist_from_iter=20, node_force_densify_prune_step=25,
                   densify_until_iter=50)


def phase_5b(dev, card) -> dict:
    """The Trainer from a 100,000-point cloud through stage 1, the node
    downsampling and the main stage with densification, at 800x800 on the
    dense route (K3/K4), on a video of the phase-3 scene."""
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.synthetic import rigid_motion, video_cameras
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train import trainer as T
    from d2dgs_torch.train.config import TrainConfig
    t0 = time.time()
    gauss, _, _ = full_scene(dev)
    cams = video_cameras(8, 4, 800, 800, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        images = [render(c, gauss, bg, d_xyz=rigid_motion(gauss.xyz, c.time)
                         - gauss.xyz).image for c in cams]
    del gauss
    rs = np.random.RandomState(0)
    n_pts = 100_000
    pts = rs.random((n_pts, 3)) * 2.6 - 1.3
    cols = 0.5 + 0.28209479177387814 * rs.random((n_pts, 3)) / 255
    cfg = TrainConfig(raster=RasterConfig(use_workqueue=False),
                      **SCHEDULE_5B)
    tr = T.Trainer(cfg, cams, images, pts.astype(np.float32),
                   cols.astype(np.float32), cameras_extent=4.0, seed=0,
                   device=dev)
    torch.cuda.synchronize()
    log(f"[phase 5b] video of {len(cams)} 800x800 views rendered and "
        f"Trainer built ({int(tr.state.gauss.num_alive)} Gaussians, "
        f"{int(tr.state.ngauss.num_alive)} node Gaussians, "
        f"{int(tr.state.nodes.num_alive)} nodes) in {time.time() - t0:.1f} s")

    # the stage-1 step's stages on the initial state, with every term on
    node_stages = node_stage_ms(tr.state, cams[0], tr.images[0], cfg,
                                dict(time_interval=tr.time_interval))
    log(f"[phase 5b] stage-1 step on the initial state ({card}), stages (ms, "
        f"each timed alone): " + json.dumps(node_stages))

    infos, originals = [], {}
    for name in ("densify_step", "node_densify_step"):
        def recorded(*a, _f=getattr(T, name), _n=name, **k):
            state, info = _f(*a, **k)
            infos.append((_n, tr.iteration_node, tr.iteration,
                          {key: int(v) for key, v in info.items()}))
            return state, info
        originals[name] = getattr(T, name)
        setattr(T, name, recorded)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows, downsampled = [], None
    for i in range(tr.total_iterations()):
        stage = ("node" if tr.iteration_node < cfg.iterations_node_rendering
                 else "main")
        it = tr.iteration_node if stage == "node" else tr.iteration
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = tr.step()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        delta = {k: v - before[k] for k, v in launch_counts().items()
                 if k.startswith("blend")}
        want = 1 if m else 0
        if delta != {"blend_fwd": 0, "blend_bwd": 0,
                     "blend_dense_fwd": want, "blend_dense_bwd": want,
                     "blend3d_fwd": 0, "blend3d_bwd": 0}:
            raise AssertionError(f"{stage} iteration {it}: launches {delta}")
        if stage == "node" and it == cfg.iterations_node_sampling:
            downsampled = int(tr.state.ngauss.num_alive)
        if m:
            check_finite(tr.state, m, stage, it)
            rows.append((stage, it, float(m["loss"]), float(m["psnr"]),
                         int(m["num_pairs"]), int(m["overflow"]), ms))
            log(f"[phase 5b] {stage} {it}: L1 {rows[-1][2]:.5f}, PSNR "
                f"{rows[-1][3]:.3f}, pairs {rows[-1][4]}, overflow "
                f"{rows[-1][5]}, {ms:.2f} ms")
        else:
            log(f"[phase 5b] {stage} {it}: no step (downsampling), "
                f"{ms:.2f} ms")
    counts = launch_counts()
    for name, f in originals.items():
        setattr(T, name, f)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, it_n, it_m, info in infos:
        log(f"[phase 5b] {name} at node iteration {it_n}, main iteration "
            f"{it_m}: {info}")
    if downsampled != cfg.node_num:
        raise AssertionError(f"{downsampled} node Gaussians alive after the "
                             f"downsampling, expected {cfg.node_num}")
    node = [r for r in rows if r[0] == "node"]
    early = [r[3] for r in node if r[1] < cfg.opacity_reset_interval]
    if not np.mean(early[-5:]) > np.mean(early[:5]):
        raise AssertionError(f"stage-1 PSNR did not rise before the first "
                             f"opacity reset: {early}")
    node_ms = [r[6] for r in node[1:]]
    main_ms = [r[6] for r in rows if r[0] == "main"][1:]
    pairs = {st: [r[4] for r in rows if r[0] == st] for st in ("node", "main")}
    res = {"node_step_ms": float(np.mean(node_ms)),
           "main_step_ms": float(np.mean(main_ms)),
           "node_step_ms_median": float(np.median(node_ms)),
           "main_step_ms_median": float(np.median(main_ms)),
           "pairs_range": {st: [min(v), max(v)] for st, v in pairs.items()},
           "node_stages_ms": node_stages,
           "peak_gb": peak_gb,
           "launches": counts, "steps": len(rows),
           "psnr_first5": float(np.mean(early[:5])),
           "psnr_before_reset": float(np.mean(early[-5:])),
           "alive_end": int(tr.state.gauss.num_alive),
           "nodes_end": int(tr.state.nodes.num_alive),
           "overflow_max": max(r[5] for r in rows), "densify": infos}
    log(f"[phase 5b] {len(rows)} training steps ({card}): node stage mean "
        f"{res['node_step_ms']:.2f} ms (median "
        f"{res['node_step_ms_median']:.2f}), main stage mean "
        f"{res['main_step_ms']:.2f} ms (median "
        f"{res['main_step_ms_median']:.2f}) per step (each stage's first "
        f"step excluded); pairs per view {res['pairs_range']}; overflow max "
        f"{res['overflow_max']}; stage-1 PSNR {res['psnr_first5']:.3f} (steps 1-5) -> "
        f"{res['psnr_before_reset']:.3f} (the 5 before the opacity reset); "
        f"{res['alive_end']} Gaussians and {res['nodes_end']} nodes alive at "
        f"the end; launches {counts}; peak memory {peak_gb:.2f} GB")
    return res


# phase 6: the command line on a D-NeRF scene written from the phase-3
# scene; the CLI's own flags at full width, the schedule past the warm-up
# and the normal/distortion start, so every loss term is on
CLI_FLAGS = ["--gaussian_capacity", "100000", "--sh_degree", "3",
             "--gt_alpha_mask_as_dynamic_mask"]
CLI_SIZE = 800          # the views' height and width
CLI_MESH = ["--max_times", "1"]     # at the CLI's default voxel, 0.004
CLI_START = 8001        # the checkpoint's main-stage iteration
CLI_STEPS = 40          # main-stage steps of `cli train --resume`
N_TEST = 4
FRAME_NAME = "{k:03d}"  # the D-NeRF frames' names


def run_cli(argv) -> dict:
    """``d2dgs_torch.cli.main(argv)`` (what ``python -m d2dgs_torch.cli``
    calls) in this process; returns the measurements it reports."""
    from d2dgs_torch import cli
    report = {}
    rc = cli.main(list(argv), report=report)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return report


def write_scene(root, gauss, nodes, deform_cfg, dev):
    """The phase-3 scene rendered through K1 at 800x800 from 8 orbit
    cameras x 4 times (train) and 4 cameras between them (test), written
    as a D-NeRF scene: RGBA PNGs (colour un-premultiplied, alpha the
    render's accumulated alpha) and transforms_{train,test}.json; frame
    k is named ``{k:03d}``, so phase 8's flow files can name it."""
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.data.synthetic import video_cameras, write_dnerf_scene
    from d2dgs_torch.eval.render_sets import render_view
    train = video_cameras(8, 4, CLI_SIZE, CLI_SIZE, device=dev)
    test = [orbit_camera(2 * np.pi * (i + 0.5) / N_TEST, 0.3, 4.0, fov=0.9,
                         H=CLI_SIZE, W=CLI_SIZE, time=(i + 0.5) / N_TEST,
                         device=dev)
            for i in range(N_TEST)]
    bg = torch.zeros(3, device=dev)

    def rgba(cam):
        out = render_view(cam, gauss, nodes, deform_cfg, RasterConfig(), bg)
        a = out.alpha
        rgb = torch.where(a > 0, out.image / torch.clamp_min(a, 1e-6), 0.0)
        return torch.cat([rgb, a], -1).clamp(0, 1).cpu().numpy()
    write_dnerf_scene(str(root), {"train": [(c, rgba(c)) for c in train],
                                  "test": [(c, rgba(c)) for c in test]},
                      name=FRAME_NAME)
    return len(train), len(test)


def write_checkpoint(path, scene_dir, gauss, nodes, dev):
    """The phase-3 scene as the CLI's own TrainState (the template
    ``cli train`` builds from these flags), Adam's moments warmed by a
    few steps on training views (parameters put back), colours and
    opacities then perturbed from a seed; saved as a format-2 checkpoint
    at main-stage iteration CLI_START, after stage 1."""
    from d2dgs_torch import cli
    from d2dgs_torch.io.checkpoint import save_train_state
    from d2dgs_torch.train.trainer import (GAUSS_FIELDS, NODE_FIELDS,
                                           init_train_state)
    args = cli._base_parser("train", True).parse_args(
        ["-s", str(scene_dir), "-m", "unused", *CLI_FLAGS])
    cfg = cli.config_from_args(args)
    info = cli._load_scene(args, dev)
    state = init_train_state(cfg, *cli._init_points(info, cfg, args.seed),
                             device=dev)
    with torch.no_grad():
        for f in GAUSS_FIELDS + ("alive",):
            getattr(state.gauss, f).copy_(getattr(gauss, f))
        state.gauss.active_sh_degree = gauss.active_sh_degree
        for f in NODE_FIELDS + ("alive",):
            getattr(state.nodes, f).copy_(getattr(nodes, f))
        for p, q in zip(state.nodes.mlp.parameters(),
                        nodes.mlp.parameters()):
            p.copy_(q)
    scheds = phase4_schedules(cfg, 8)
    bg = np.zeros(3, np.float32)
    for i, s in enumerate(info.train_cameras[::8]):
        gt = torch.as_tensor(s.gt(bg), device=dev)
        state = warm_moments(state, s.camera, gt, cfg, scheds[2 * i:2 * i + 2])
    perturb(state.gauss, seed=11)
    save_train_state(str(path), state, CLI_START, cfg.iterations_node_rendering)
    return cfg


def check_ply_matches(ply_path, ckpt_path, cfg, dev):
    """The PLY holds the alive rows of the checkpoint beside it."""
    from d2dgs_torch.io.ply import load_gaussian_ply
    from d2dgs_torch.train.trainer import GAUSS_FIELDS
    p = load_gaussian_ply(str(ply_path), capacity=cfg.gaussian_capacity,
                          sh_degree=cfg.sh_degree, fea_dim=cfg.hyper_dim,
                          with_motion_mask=True, device=dev)
    n = int(p.num_alive)
    with np.load(ckpt_path) as z:
        alive = z["leaf:.gauss.alive"]
        if n != int(alive.sum()):
            raise AssertionError(f"PLY has {n} rows, checkpoint {alive.sum()}"
                                 f" alive")
        for f in GAUSS_FIELDS:
            if not np.array_equal(getattr(p, f).detach().cpu().numpy()[:n],
                                  z["leaf:.gauss." + f][alive]):
                raise AssertionError(f"PLY {f} differs from the checkpoint")
    return n


def check_checkpoint_roundtrip(ckpt_path, scene_dir, dev):
    """A checkpoint read back and written again holds the same arrays."""
    from d2dgs_torch import cli
    from d2dgs_torch.io.checkpoint import load_train_state, save_train_state
    from d2dgs_torch.train.trainer import init_train_state
    args = cli._base_parser("render", False).parse_args(
        ["-s", str(scene_dir), "-m", "unused", *CLI_FLAGS])
    cfg = cli.config_from_args(args)
    info = cli._load_scene(args, dev)
    template = init_train_state(cfg, *cli._init_points(info, cfg, 0),
                                device=dev)
    state, it, it_node = load_train_state(str(ckpt_path), template)
    again = Path(str(ckpt_path) + ".again.npz")
    save_train_state(str(again), state, it, it_node)
    with np.load(ckpt_path) as a, np.load(again) as b:
        if a.files != b.files:
            raise AssertionError("checkpoint keys changed on a round trip")
        for k in a.files:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"checkpoint {k} changed on a round "
                                     f"trip")
    return len(a.files)


def phase_6(dev, card, tmp: Path) -> dict:
    """train --resume, render (test and time), mesh through the CLI on a
    D-NeRF scene of the phase-3 scene, at full width; the scene and the
    start checkpoint stay in ``tmp`` for phase 8."""
    from d2dgs_torch import native
    t_start = time.time()
    gauss, nodes, deform_cfg = full_scene(dev)
    scene, model = tmp / "scene", tmp / "model"
    n_train, n_test = write_scene(scene, gauss, nodes, deform_cfg, dev)
    start_ckpt = tmp / "start.npz"
    cfg = write_checkpoint(start_ckpt, scene, gauss, nodes, dev)
    del gauss, nodes
    torch.cuda.empty_cache()
    log(f"[phase 6] D-NeRF scene ({n_train} train, {n_test} test views "
        f"at {CLI_SIZE}x{CLI_SIZE}) and the start checkpoint written in "
        f"{time.time() - t_start:.1f} s")
    common = ["-s", str(scene), "-m", str(model), *CLI_FLAGS]
    reset_counts()
    t0 = time.time()
    run_cli(["render", *common, "--ckpt", str(start_ckpt)])
    with open(model / "results.json") as fh:
        before = json.load(fh)
    # the main stage runs iterations 1 .. --iterations + 1
    last = CLI_START + CLI_STEPS - 1
    # each step timed between two device synchronisations
    step_ms = run_cli(["train", *common, "--resume", str(start_ckpt),
                       "--iterations", str(last - 1),
                       "--test_iterations", str(last),
                       "--save_iterations", str(last), "--log_every",
                       "10"])["step_ms"]
    view_ms = run_cli(["render", "-s", str(scene), "-m",
                       str(model)])["view_ms"]
    with open(model / "results.json") as fh:
        after = json.load(fh)
    meshes = run_cli(["mesh", "-s", str(scene), "-m", str(model),
                      *CLI_MESH])["meshes"]
    counts = launch_counts()
    t1 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "d2dgs_torch.cli", "render", "-s",
         str(scene), "-m", str(model), "--mode", "time", "--n_frames",
         "8"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(proc.stdout.strip())
    if proc.returncode != 0:
        raise AssertionError(f"python -m d2dgs_torch.cli render --mode "
                             f"time exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    sub_s = time.time() - t1
    cli_s = time.time() - t0

    # ---- checks ----
    files = ["cfg_args.json", "ckpt.npz", "ckpt_best.npz",
             "results.json", f"point_cloud/iteration_{last}/"
             f"point_cloud.ply", f"training_renders/iter_{last}/"
             f"view_00.png", "test/renders/renders/00003.png",
             "test/renders/depth/00003.png", "time/video.gif",
             "time/00007.png", "mesh/mesh_0000.ply"]
    missing = [f for f in files if not (model / f).exists()]
    if missing:
        raise AssertionError(f"phase 6: missing {missing}")
    keys = {"psnr", "ssim", "ms_ssim", "lpips_rand"}
    if set(after) != keys or set(before) != keys:
        raise AssertionError(f"results.json keys {sorted(after)}")
    if not after["psnr"] >= before["psnr"] - 1.0:
        raise AssertionError(f"test PSNR {before['psnr']:.3f} -> "
                             f"{after['psnr']:.3f} after training")
    n_ply = check_ply_matches(
        model / f"point_cloud/iteration_{last}/point_cloud.ply",
        model / "ckpt.npz", cfg, dev)
    n_keys = check_checkpoint_roundtrip(model / "ckpt.npz", scene, dev)
    if len(meshes) != 1 or meshes[0]["faces"] == 0:
        raise AssertionError(f"phase 6: empty mesh ({meshes})")
    if len(step_ms) != CLI_STEPS:
        raise AssertionError(f"{len(step_ms)} train steps, expected "
                             f"{CLI_STEPS}")
    for k in ("blend_fwd", "blend_bwd"):
        if counts[k] == 0:
            raise AssertionError(f"phase 6: {k} not launched")
    if counts["blend_dense_fwd"] or counts["blend_dense_bwd"]:
        raise AssertionError(f"phase 6 launched the dense route: "
                             f"{counts}")
    if not native.available():
        raise AssertionError("phase 6: the native mesh library did not "
                             "load")
    res = {"launches": counts, "before": before, "after": after,
           "step_ms": step_ms, "view_ms": view_ms,
           "train_step_ms": float(np.mean(step_ms[1:])),
           "train_step_ms_median": float(np.median(step_ms[1:])),
           "mesh_verts": meshes[0]["verts"],
           "mesh_faces": meshes[0]["faces"],
           "grid": "x".join(map(str, meshes[0]["dims"])),
           "voxels": meshes[0]["voxels"], "grid_bytes": meshes[0]["bytes"],
           "integrate_ms": meshes[0]["integrate_ms"],
           "integrate_views": meshes[0]["views"],
           "extract_ms": meshes[0]["extract_ms"], "ply_rows": n_ply,
           "ckpt_arrays": n_keys, "subprocess_s": sub_s, "cli_s": cli_s,
           "scene": scene, "start_ckpt": start_ckpt, "cfg": cfg}
    log(f"[phase 6] cli train --resume: {CLI_STEPS} main-stage steps, "
        f"{res['train_step_ms']:.2f} ms per step (mean of steps 2-"
        f"{CLI_STEPS}, each between two device synchronisations; median "
        f"{res['train_step_ms_median']:.2f}) ({card})")
    log(f"[phase 6] cli render: {view_ms:.1f} ms per {CLI_SIZE}x{CLI_SIZE} "
        f"test view "
        f"(render, metrics and PNGs); test PSNR {before['psnr']:.3f} -> "
        f"{after['psnr']:.3f}, SSIM {before['ssim']:.4f} -> "
        f"{after['ssim']:.4f}, MS-SSIM {before['ms_ssim']:.4f} -> "
        f"{after['ms_ssim']:.4f}, lpips_rand {before['lpips_rand']:.6f} -> "
        f"{after['lpips_rand']:.6f}")
    log(f"[phase 6] cli mesh {' '.join(CLI_MESH)}: grid {res['grid']}, "
        f"{res['voxels']} voxels, {res['grid_bytes']} bytes; integrate "
        f"{res['integrate_ms']:.1f} ms ({res['integrate_views']} views), "
        f"extract {res['extract_ms']:.1f} ms; {res['mesh_verts']} verts, "
        f"{res['mesh_faces']} faces")
    log(f"[phase 6] PLY {n_ply} rows = the checkpoint's alive rows; "
        f"checkpoint of {n_keys} arrays bitwise equal after a round trip; "
        f"`python -m d2dgs_torch.cli render --mode time` {sub_s:.1f} s; "
        f"launches in the in-process CLI runs {counts}; phase 6 "
        f"{time.time() - t_start:.1f} s")
    return res


def check_finite(state, metrics, stage, it):
    """Finite loss, moments and parameters of the stage's three groups."""
    from d2dgs_torch.train.trainer import (gauss_trainable, mlp_trainable,
                                           node_trainable)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"{stage} {it}: loss {metrics['loss']}")
    points, opt = ((state.ngauss, state.ngauss_opt) if stage == "node"
                   else (state.gauss, state.gauss_opt))
    for name, params, o in (("points", gauss_trainable(points), opt),
                            ("mlp", mlp_trainable(state.nodes),
                             state.mlp_opt),
                            ("node", node_trainable(state.nodes),
                             state.node_opt)):
        for k, p in params.items():
            for what, t in (("param", p), ("mu", o.mu[k]), ("nu", o.nu[k])):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{stage} {it}: non-finite {what} "
                                         f"of {name}.{k}")


# phase 7: the geometry path on the articulated figure, at the widths of
# tools/convergence_torch.py (seed 0, 12 cameras x 8 times at 800x800,
# 60,000 surfels, capacity 120,000, 1,024 nodes, the 8x256 MLP) with its
# --fast schedule (200 stage-1 and 600 main-stage iterations)
PSNR_OVER_EMPTY = 3.0   # dB the short run's test views must gain over
                        # an empty render (the guard against flee-collapse)


def convergence_tool():
    """tools/convergence_torch.py, imported as a module."""
    sys.path.insert(0, str(ROOT / "tools"))
    import convergence_torch
    return convergence_torch


def synced_ms(fn):
    """(fn(), wall ms) with the device synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def silhouette_share(covered: np.ndarray, alpha: np.ndarray) -> float:
    """The share of the ground-truth silhouette (alpha > 0.5) that a mesh
    render covers."""
    sil = alpha.reshape(covered.shape) > 0.5
    return float((covered & sil).sum() / max(int(sil.sum()), 1))


def launch_binning(pair_rank, tile_start, tile_count):
    """The binning fields check_kernel and check_backward read, from a
    blend launch's own arguments."""
    import types
    return types.SimpleNamespace(pair_rank=pair_rank, tile_start=tile_start,
                                 tile_count=tile_count,
                                 num_pairs=int(tile_count.sum()))


def all_finite(state) -> bool:
    from d2dgs_torch.io.checkpoint import tensor_leaves
    return all(bool(torch.isfinite(t).all())
               for t in tensor_leaves(state).values()
               if t.is_floating_point())


def phase_7(dev, card) -> dict:
    """The ground truth, its mesh, a short training run and ``cli mesh
    --render_meshes`` on the articulated figure, at full width."""
    import tempfile

    from PIL import Image

    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.articulated import gt_gaussians
    from d2dgs_torch.eval.mesh_metrics import score_mesh
    from d2dgs_torch.mesh.extract import reconstruct_mesh
    from d2dgs_torch.mesh.render import mesh_shape_render, render_mesh
    from d2dgs_torch.mesh.tsdf import load_mesh_ply
    from d2dgs_torch.models.deform import DeformConfig
    from d2dgs_torch.ops.ssim import psnr
    conv = convergence_tool()
    t_start = time.time()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # ---- the ground-truth video, through K1 ----
    busiest = {"pairs": -1}

    def keep_busiest(args, kwargs):
        """The K1 arguments of the view with the fullest tile."""
        top = int(args[3].max())
        if top > busiest["pairs"]:
            busiest.update(pairs=top, args=args)

    reset_counts()
    with kernel_inputs("blend_fwd", keep_busiest):
        data, gen_ms = synced_ms(lambda: conv.make_data(dev, **conv.SIZE))
    counts = launch_counts()
    add(counts)
    cams, imgs, alphas = data["cams"], data["imgs"], data["alphas"]
    scene = data["scene"]
    if counts["blend_fwd"] != len(cams) or len(cams) != 96 \
            or counts["blend_bwd"] or counts["blend_dense_fwd"]:
        raise AssertionError(f"phase 7: ground-truth renders launched "
                             f"{counts} for {len(cams)} views")
    for k, (img, al) in enumerate(zip(imgs, alphas)):
        if not (np.isfinite(img).all() and (al > 0.5).any()):
            raise AssertionError(f"phase 7: ground-truth view {k} is not "
                                 f"finite or has an empty alpha")
    log(f"[phase 7] ground truth: {len(cams)} views of {scene.n_surfels} "
        f"surfels at {conv.SIZE['H']}x{conv.SIZE['W']} in {gen_ms:.1f} ms "
        f"({gen_ms / len(cams):.1f} ms per view with the host scene), "
        f"{counts['blend_fwd']} K1 launches, overflow 0 (the dataset "
        f"raises otherwise) ({card})")
    # K1 against its plain version on that view's own inputs, at the
    # ground truth's tile_cap 8192 (the launches of this check and the
    # next are not counted)
    fs, pair_rank, tile_start, tile_count, gx, chunk = busiest.pop("args")
    label = (f"ground-truth view with the fullest tile ({busiest['pairs']} "
             f"pairs, tile_cap 8192)")
    with torch.no_grad():
        _, res_gt = check_kernel(label, fs, launch_binning(
            pair_rank, tile_start, tile_count), gx, chunk, tag="phase 7")
    res_gt.pop("flip_mask")
    res_gt["busiest_tile_pairs"] = busiest["pairs"]
    del fs, pair_rank, tile_start, tile_count

    # ---- the ground-truth mesh at t = 0 (static deform) ----
    parts = [(p.name, len(p.pos)) for p in scene.parts]
    gt_pts, _ = scene.surfel_positions(0.0)
    views0 = [k for k, c in enumerate(cams) if float(c.time) == 0.0]
    g0 = gt_gaussians(scene, 0.0, device=dev)
    rep = {}
    reset_counts()
    verts, faces, colors = reconstruct_mesh(
        [cams[k] for k in views0], g0, None, None,
        RasterConfig(tile_cap=8192, chunk=64), mesh_time=0.0,
        alpha_masks=[alphas[k] for k in views0], voxel=conv.MESH_VOXEL,
        keep_clusters=16, return_colors=True,
        deform_cfg=DeformConfig(deform_type="static"), report=rep)
    add(launch_counts())
    del g0
    gt_score = score_mesh(verts, faces, gt_pts, parts, device=dev)
    log(f"[phase 7] ground-truth mesh at t=0 from {len(views0)} views, voxel "
        f"{conv.MESH_VOXEL}: grid {'x'.join(map(str, rep['dims']))}, "
        f"fusion {rep['integrate_ms']:.1f} ms, extraction "
        f"{rep['extract_ms']:.1f} ms, {verts.shape[0]} verts, "
        f"{faces.shape[0]} faces; chamfer {gt_score['chamfer']:.5f} "
        f"(pred->gt {gt_score['pred_to_gt']:.5f}, gt->pred "
        f"{gt_score['gt_to_pred']:.5f}; ceiling {conv.CHAMFER_CEIL}); "
        f"gt->pred by part "
        + json.dumps({k: round(v, 4) for k, v in gt_score["by_part"].items()})
        + f" ({card})")
    if not gt_score["chamfer"] <= conv.CHAMFER_CEIL:
        raise AssertionError(f"phase 7: ground-truth mesh chamfer "
                             f"{gt_score['chamfer']:.5f} > "
                             f"{conv.CHAMFER_CEIL}")
    # the mesh rasterizer on it, from the first t=0 view
    cam0, alpha0 = cams[views0[0]], alphas[views0[0]]
    renders = {}
    for name, fn in (("render_mesh",
                      lambda: render_mesh(cam0, verts, faces, colors)),
                     ("mesh_shape_render",
                      lambda: mesh_shape_render(cam0, verts, faces))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (img, _, mask), ms = synced_ms(fn)
        peak = torch.cuda.max_memory_allocated() - base
        share = silhouette_share(mask.cpu().numpy() > 0, alpha0)
        if not (torch.isfinite(img).all() and share > 0.5):
            raise AssertionError(f"phase 7: {name} of the ground-truth mesh "
                                 f"covers {share:.3f} of the silhouette")
        renders[name] = {"ms": ms, "peak_bytes": peak, "share": share}
    log(f"[phase 7] ground-truth mesh renders at {cam0.H}x{cam0.W}: "
        f"render_mesh "
        f"{renders['render_mesh']['ms']:.1f} ms (peak "
        f"{renders['render_mesh']['peak_bytes']} B above the inputs, "
        f"silhouette covered {renders['render_mesh']['share']:.4f}), "
        f"mesh_shape_render {renders['mesh_shape_render']['ms']:.1f} ms "
        f"(peak {renders['mesh_shape_render']['peak_bytes']} B, "
        f"{renders['mesh_shape_render']['share']:.4f}) ({card})")
    torch.cuda.empty_cache()

    # ---- a short training run: the tool's --fast schedule ----
    cfg = conv.train_config(fast=True)
    tr = conv.make_trainer(cfg, data, dev)
    test = [k for k in range(len(cams)) if k in data["test_idx"]]
    empty = float(np.mean([float(psnr(torch.zeros(imgs[k].shape,
                                                  device=dev),
                                      torch.as_tensor(imgs[k], device=dev)))
                           for k in test]))
    reset_counts()
    node_steps, main_ms, losses, at_main = 0, [], [], None
    last_step = {}
    for i in range(tr.total_iterations()):
        main = tr.iteration_node >= cfg.iterations_node_rendering
        if main and at_main is None:
            at_main = launch_counts()
        if i < tr.total_iterations() - 1:
            m, ms = synced_ms(tr.step)
        else:   # keep the last main-stage step's K2 arguments
            with kernel_inputs("blend_bwd",
                               lambda a, k: last_step.update(args=a, kw=k)):
                m, ms = synced_ms(tr.step)
        if not m:
            continue
        losses.append(float(m["loss"]))
        if main:
            main_ms.append(ms)
        else:
            node_steps += 1
    counts = launch_counts()
    add(counts)
    main_counts = {k: counts[k] - at_main[k] for k in counts}
    if not (np.isfinite(losses).all() and all_finite(tr.state)):
        raise AssertionError("phase 7: a non-finite loss or parameter")
    # the main stage runs iterations 1 .. cfg.iterations + 1
    if not (main_counts["blend_fwd"] == main_counts["blend_bwd"]
            == len(main_ms) == cfg.iterations + 1):
        raise AssertionError(f"phase 7: {main_counts} launches over "
                             f"{len(main_ms)} main-stage steps")
    if not (at_main["blend_fwd"] == at_main["blend_bwd"] == node_steps) \
            or counts["blend_dense_fwd"] or counts["blend_dense_bwd"]:
        raise AssertionError(f"phase 7: {at_main} launches over "
                             f"{node_steps} stage-1 steps, {counts} in all")
    final = conv.test_metrics(tr, data)
    alive = int(tr.state.gauss.num_alive)
    log(f"[phase 7] --fast run: {node_steps} stage-1 and {len(main_ms)} "
        f"main-stage steps, a main-stage step {np.mean(main_ms[1:]):.2f} ms "
        f"(mean of steps 2-{len(main_ms)}, median "
        f"{np.median(main_ms[1:]):.2f}, each between two device "
        f"synchronisations) ({card}); test PSNR {final['psnr']:.3f} against "
        f"{empty:.3f} for an empty render (+{final['psnr'] - empty:.3f} dB), "
        f"SSIM {final['ssim']:.4f}, MS-SSIM {final['ms_ssim']:.4f}, "
        f"lpips_rand {final['lpips_rand']:.6f}; {alive} alive; K1/K2 "
        f"launches {at_main['blend_fwd']}/{at_main['blend_bwd']} in stage "
        f"1, {main_counts['blend_fwd']}/{main_counts['blend_bwd']} in the "
        f"main stage")
    if not final["psnr"] >= empty + PSNR_OVER_EMPTY:
        raise AssertionError(f"phase 7: test PSNR {final['psnr']:.3f} is not "
                             f"{PSNR_OVER_EMPTY} dB over the empty render's "
                             f"{empty:.3f}")
    # K1 and K2 against their plain versions on the last step's own
    # inputs and cotangent, at the training tile_cap
    fs, pair_rank, tile_start, tile_count, gx, _, _, g, _ = last_step["args"]
    chunk = last_step["kw"]["chunk"]
    binning = launch_binning(pair_rank, tile_start, tile_count)
    top = int(tile_count.max())
    label = (f"main-stage step {cfg.iterations + 1} (fullest tile {top} "
             f"pairs, tile_cap {cfg.raster.tile_cap})")
    with torch.no_grad():
        _, res_step = check_kernel(label, fs, binning, gx, chunk,
                                   tag="phase 7")
        res_step_bwd = check_backward(
            label + ", its own cotangent on the 16 fullest + 48 seeded "
            "tiles", fs, binning, gx, chunk, res_step.pop("flip_mask"),
            tiles=heavy_and_random_tiles(tile_count, 16, 48, seed=8), g=g,
            tag="phase 7")
    res_step["busiest_tile_pairs"] = res_step_bwd["busiest_tile_pairs"] = top
    del last_step, fs, pair_rank, tile_start, tile_count, g, binning
    torch.cuda.empty_cache()

    # ---- the CLI on the trained state ----
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="d2dgs_phase7_") as tmp:
        mesh = conv.mesh_and_score(cfg, tr, data, (0.0,), tmp, log=log)
        model = Path(tmp) / "model"
        v, f = load_mesh_ply(model / "mesh" / "mesh_0000.ply")
        if f.shape[0] == 0:
            raise AssertionError("phase 7: cli mesh wrote an empty PLY")
        # cli mesh renders from the first test view, view 0 at t = 0
        shares = {}
        for sub in ("mesh_image", "mesh_shape"):
            png = model / sub / "0000.png"
            if not png.exists():
                raise AssertionError(f"phase 7: {sub}/0000.png missing")
            img = np.asarray(Image.open(png))
            # render_mesh's background is white
            shares[sub] = silhouette_share((img != 255).any(-1), alphas[0])
            if not shares[sub] > 0:
                raise AssertionError(f"phase 7: {sub}/0000.png covers none "
                                     f"of the silhouette")
    add(launch_counts())
    cli = mesh["cli"][0]
    log(f"[phase 7] cli mesh --times 0.0 --voxel_size {conv.MESH_VOXEL} "
        f"--render_meshes: {f.shape[0]} faces, grid "
        f"{'x'.join(map(str, cli['dims']))}, fusion "
        f"{cli['integrate_ms']:.1f} ms, extraction {cli['extract_ms']:.1f} "
        f"ms, render_mesh {cli['render_mesh_ms']:.1f} ms, mesh_shape_render "
        f"{cli['mesh_shape_ms']:.1f} ms ({card}); chamfer "
        f"{mesh['chamfer'][0]} (pred->gt {mesh['pred_to_gt'][0]}, gt->pred "
        f"{mesh['gt_to_pred'][0]}); silhouette covered: "
        + json.dumps({k: round(v, 4) for k, v in shares.items()}))
    log(f"[phase 7] launches {launches}; phase 7 "
        f"{time.time() - t_start:.1f} s")
    return {"launches": launches, "gen_ms": gen_ms,
            "fwd_checks": {"geometry gt view": res_gt,
                           "geometry step": res_step},
            "bwd_checks": {"geometry step": res_step_bwd},
            "gt_chamfer": gt_score["chamfer"],
            "main_step_ms": float(np.mean(main_ms[1:])),
            "test_psnr": final["psnr"], "empty_psnr": empty,
            "render_mesh_ms": renders["render_mesh"]["ms"],
            "mesh_shape_ms": renders["mesh_shape_render"]["ms"]}


# ----------------------------------------------------------------------
# phase 8: the optical-flow training path on phase 6's D-NeRF scene with
# RAFT-format flow files: one per training view, toward the same camera
# at the next time (the last time toward the one before, so every view
# has one), every fourth at FLOW_SMALL x FLOW_SMALL; `cli train --resume`
# from phase 6's start checkpoint, where lambda_optical is 0.1

FLOW_SMALL = 400        # the size of every fourth flow file
FLOW_STEPS = 40         # main-stage steps of `cli train --resume`
N_TIMES = 4             # the scene's times per camera (write_scene)
CROP_TILES = 16         # the CPU check's crop, in tiles a side
MIN_SOLID = 10_000      # pixels of the self-check's view with alpha > 0.9


def flow_target(k: int) -> int:
    """The training frame that frame k's flow file points at."""
    return k + 1 if k % N_TIMES < N_TIMES - 1 else k - 1


def scene_flow(gauss, nodes, deform_cfg, cam1, cam2, cfg, step):
    """``render_flow`` of the scene between cam1's and cam2's times, with
    the deformation ``optical_flow_loss`` gives it."""
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.render.renderer import render_flow
    d1, d2 = (deform_gaussians(nodes, deform_cfg, gauss.xyz, c.time,
                               feature=gauss.feature,
                               motion_mask=gauss.motion_mask, step=step)
              for c in (cam1, cam2))
    return render_flow(gauss, cam1, cam2, d1["d_xyz"], d2["d_xyz"],
                       d_rotation1=d1["d_rotation"],
                       d_scaling1=d1["d_scaling"], cfg=cfg)


@torch.no_grad()
def flow_raster_inputs(gauss, nodes, deform_cfg, cam1, cam2, step) -> list:
    """The five inputs ``render_flow`` hands ``rasterize_3dgs`` for the
    flow from cam1's time to cam2's (means, scales, quaternions,
    opacities, the uv flow and the motion mask), detached."""
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.render.renderer import _full_proj_uvz
    from d2dgs_torch.utils.quaternion import quat_normalize
    d1, d2 = (deform_gaussians(nodes, deform_cfg, gauss.xyz, c.time,
                               feature=gauss.feature,
                               motion_mask=gauss.motion_mask, step=step)
              for c in (cam1, cam2))
    uv = (_full_proj_uvz(gauss.xyz + d2["d_xyz"], cam2)
          - _full_proj_uvz(gauss.xyz + d1["d_xyz"], cam1))[:, :2]
    return [gauss.xyz + d1["d_xyz"], gauss.get_scaling + d1["d_scaling"],
            quat_normalize(gauss.rotation + d1["d_rotation"], eps=1e-12),
            torch.where(gauss.alive, gauss.get_opacity[:, 0], 0.0),
            torch.cat([uv, gauss.motion_mask], -1)]


def flow_raster_route(plain: bool, inputs, cam, cfg):
    """(image, depth, alpha) of ``rasterize_3dgs`` on the five flow
    inputs, its tile blend through K5/K6 or, with ``plain``, through the
    plain walk ``blend3d_plain`` (the same preprocess, binning and image
    assembly around it), on a background of 0."""
    from d2dgs_torch.ops import raster3d
    if not plain:
        img, _, depth, alpha = raster3d.rasterize_3dgs(*inputs, cam, cfg=cfg)
        return img, depth, alpha
    _, args = raster3d.blend3d_inputs(*inputs, cam, cfg=cfg)
    bg = torch.zeros((3,), device=inputs[0].device)
    return raster3d.blend3d_images(*raster3d.blend3d_plain(*args), bg,
                                   cam.H, cam.W)


@torch.no_grad()
def write_flow_files(scene, gauss, nodes, deform_cfg, cams, cfg) -> dict:
    """RAFT-format files from the port's own flow renders of the
    unperturbed scene, in pixels (x [W/2, H/2], the inverse of
    ``load_flow``'s normalisation); the masks mark the pixels the render
    covers (alpha > 0.5); every fourth file is pooled to FLOW_SMALL (its
    values scaled with the size) and has no mask file."""
    from d2dgs_torch.data.synthetic import write_flow_file
    paths = {}
    for k, cam in enumerate(cams):
        j = flow_target(k)
        f = scene_flow(gauss, nodes, deform_cfg, cam, cams[j], cfg,
                       CLI_START)
        px = f["render"][..., :2] * torch.tensor(
            [cam.W / 2.0, cam.H / 2.0], device=cam.device)
        mask = (f["alpha"] > 0.5).expand(-1, -1, 2)
        if k % 4 == 3:
            s = cam.W // FLOW_SMALL
            px = torch.nn.functional.avg_pool2d(
                px.permute(2, 0, 1)[None], s)[0].permute(1, 2, 0) / s
            mask = None
        paths[k] = write_flow_file(
            str(scene), FRAME_NAME.format(k=k), FRAME_NAME.format(k=j),
            px.cpu().numpy(),
            None if mask is None else mask.cpu().numpy())
    return paths


def flow_crop_check(dev, inputs, cam, cfg) -> dict:
    """``rasterize_3dgs`` at full width on the card against the same call
    on the CPU over the CROP_TILES x CROP_TILES tiles around the splats'
    median centre: the CPU call gets the splats whose tile rect meets the
    crop (every pair of the crop's tiles; the others only change pixels
    outside it).  K5 on the card and the plain walk on the CPU blend the
    crop's tiles from the same pair lists: a pixel whose blended count
    differs (a flip) must lie within the threshold band
    (``compare_blend3d``) and is left out of the image comparison; every
    other pixel is held to compare_blend3d's IMG_TOL (image, alpha) and
    DEPTH_TOL (depth)."""
    from d2dgs_torch.ops.cuda.raster3d import (DEPTH_TOL, IMG_TOL,
                                               blend3d_fwd, compare_blend3d,
                                               walk_cap)
    from d2dgs_torch.ops.projection import tile_grid
    from d2dgs_torch.ops.raster3d import (blend3d_inputs, blend3d_plain,
                                          preprocess3d, rasterize_3dgs)
    from d2dgs_torch.ops.tiled_raster import PIX, tiles_to_image
    means, scales, quats, opac, colors = inputs
    with torch.no_grad():
        img, radii, depth, alpha = rasterize_3dgs(*inputs, cam, cfg=cfg)
        prep = preprocess3d(means, scales, quats, cam)
    gx, gy = tile_grid(cam.H, cam.W)
    cx = min(max(int(prep.center[prep.valid, 0].median()) // 16
                 - CROP_TILES // 2, 0), gx - CROP_TILES)
    cy = min(max(int(prep.center[prep.valid, 1].median()) // 16
                 - CROP_TILES // 2, 0), gy - CROP_TILES)
    lo = torch.tensor([cx, cy], device=dev)
    hi = lo + CROP_TILES
    sel = (prep.valid & (prep.rect_min < hi).all(-1)
           & (prep.rect_max > lo).all(-1))
    cpu_cam = dataclasses.replace(
        cam, **{f: getattr(cam, f).cpu()
                for f in ("w2c", "cam_center", "fx", "fy", "time")})
    cpu_inputs = [a[sel].cpu() for a in inputs]
    t0 = time.time()
    with torch.no_grad():
        c_img, c_radii, c_depth, c_alpha = rasterize_3dgs(
            *cpu_inputs, cpu_cam, cfg=cfg)
    cpu_s = time.time() - t0
    # the crop's tiles through K5 (with its work rows) and the plain walk
    # (with its decisions)
    ty, tx = torch.meshgrid(torch.arange(cy, cy + CROP_TILES),
                            torch.arange(cx, cx + CROP_TILES), indexing="ij")
    tiles = (ty * gx + tx).flatten()
    with torch.no_grad():
        _, args = blend3d_inputs(*inputs, cam, cfg=cfg)
        work = torch.empty((args[6].shape[0], 2, PIX), dtype=torch.int32,
                           device=dev)
        card = [t[tiles.to(dev)].cpu() for t in blend3d_fwd(*args,
                                                            work=work)]
        _, c_args = blend3d_inputs(*cpu_inputs, cpu_cam, cfg=cfg)
        *plain, dec = blend3d_plain(*c_args, decisions=True)
    if not torch.equal(args[7][tiles.to(dev)].cpu(), c_args[7][tiles]):
        raise AssertionError("phase 8: the crop's tiles hold other pairs on "
                             "the CPU than on the card")
    band = compare_blend3d(card, work[tiles.to(dev)].cpu(),
                           [t[tiles] for t in plain], dec[tiles],
                           torch.clamp(c_args[7][tiles],
                                       max=walk_cap(cfg.chunk, cfg.tile_cap)))
    if band["outside_band"]:
        raise AssertionError(f"phase 8: the card's K5 and the CPU's plain "
                             f"walk blend other pair counts outside the "
                             f"threshold band on the crop: "
                             + json.dumps({k: v for k, v in band.items()
                                           if k != "flip_mask"}))
    flip = torch.zeros(gx * gy, PIX, dtype=torch.bool)
    flip[tiles] = band["flip_mask"]
    keep = ~tiles_to_image(flip[..., None], gx, gy, cam.H, cam.W)[..., 0]
    ys = slice(cy * 16, min((cy + CROP_TILES) * 16, cam.H))
    xs = slice(cx * 16, min((cx + CROP_TILES) * 16, cam.W))
    keep = keep[ys, xs]
    err = {name: float((a[ys, xs].cpu() - b[ys, xs]).abs()[keep].max())
           for name, a, b in (("image", img, c_img), ("alpha", alpha,
                                                       c_alpha),
                              ("depth", depth, c_depth))}
    if not torch.equal(radii[sel].cpu(), c_radii):
        raise AssertionError("phase 8: rasterize_3dgs radii differ between "
                             "the card and the CPU")
    if (err["image"] > IMG_TOL or err["alpha"] > IMG_TOL
            or err["depth"] > DEPTH_TOL):
        raise AssertionError(f"phase 8: rasterize_3dgs on the card against "
                             f"the CPU on the crop: {err}")
    if float(c_alpha[ys, xs].max()) <= 0.5:
        raise AssertionError("phase 8: the CPU check's crop is empty")
    return dict(err, splats=int(sel.sum()), crop_tile=[cx, cy],
                cpu_s=cpu_s, flipped=band["flipped"],
                in_band=band["in_band"],
                band_max_share=band["band_max_share"])


def blend3d_bound(args, work, n_walk=None) -> dict:
    """Least time of K5 (or, given K6's ``n_walk``, of K6) on one view:
    float32 operations of the pairs each pixel evaluated and blended
    (K5's ``work`` counts; K6 re-walks the ``n_walk`` pairs up to each
    pixel's last blended one; every evaluated pair with alpha > 0 is
    blended, so the others, ``n_eval - n_blend``, are those the walk
    refuses), against the Gaussian rows, the pair list
    and the tile arrays read once, plus K5's per-pixel rows written once
    (T, the colour and depth sums, n_walk) or K6's read once (T, n_walk,
    the cotangents) and its gradients written once."""
    from d2dgs_torch.ops.tiled_raster import PIX
    conic, colors, gid, start = args[0], args[2], args[5], args[6]
    c = colors.shape[1]
    gauss_bytes = conic.shape[0] * (7 + c) * 4
    nbytes = gauss_bytes + gid.numel() * 4 + 2 * start.numel() * 4
    pixels = start.numel() * PIX
    n_blend = float(work[:, 1].to(torch.float64).sum())
    if n_walk is None:
        n_eval = float(work[:, 0].to(torch.float64).sum())
        ops = OPS_EVAL_3D * n_eval + (OPS_KEPT_3D + OPS_BLEND_3D) * n_blend
        nbytes += pixels * (3 + c) * 4
    else:
        n_eval = float(n_walk.to(torch.float64).sum())
        ops = (OPS_EVAL_3D * n_eval
               + (OPS_KEPT_3D + OPS_BWD_BLEND_3D) * n_blend)
        nbytes += pixels * (4 + c) * 4 + gauss_bytes
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"n_eval": n_eval, "n_blend": n_blend, "ops": ops,
            "bytes": nbytes, "t_ops": t_ops, "t_bytes": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_blend3d(tag, label, args, state, work) -> dict:
    """K5's tile state (T, colour sums, depth sums) and work rows against
    blend3d_plain's on the same inputs, by ``compare_blend3d``: T bitwise
    on every tile of one 256-pair segment; each pixel whose blended pair
    count differs (a flip) must be of one pair and lie within the
    threshold band, BAND_ULPS ulps of T_CUTOFF per pair blended up to
    there, whatever the count of flips; every other pixel within
    compare_blend3d's IMG_TOL (T, colours) and DEPTH_TOL (depth), with
    the same evaluated and blended pair
    counts.  Raises otherwise; returns the result with the flip mask."""
    from d2dgs_torch.ops.cuda.raster3d import compare_blend3d, walk_cap
    from d2dgs_torch.ops.raster3d import blend3d_plain
    with torch.no_grad():
        *plain, dec = blend3d_plain(*args, decisions=True)
    res = compare_blend3d(state, work, plain, dec,
                          torch.clamp(args[7], max=walk_cap(args[9],
                                                            args[10])))
    shown = {k: v for k, v in res.items() if k != "flip_mask"}
    log(f"[{tag}] {label}: " + json.dumps(shown))
    if not res["ok"]:
        raise AssertionError(f"K5 disagrees with blend3d_plain on {label}: "
                             f"{shown}")
    return res


def check_k6(tag, label, args, state, walk, g) -> tuple:
    """K6 on K5's ``state`` and training ``walk`` against the plain VJP on
    the cotangent ``g``, zero at the pixels that K5's check judged flipped:
    K5 runs again on the same inputs for its work rows (its state must come
    out bitwise the same) and check_blend3d judges each flip first, so a
    flip outside the band fails before its cotangent is dropped.  Returns
    (K5's check, K6's check, K5's work rows)."""
    from d2dgs_torch.ops.cuda.raster3d import (blend3d_bwd, blend3d_fwd,
                                               blend3d_plain_vjp)
    from d2dgs_torch.ops.tiled_raster import PIX
    work = torch.empty((args[6].shape[0], 2, PIX), dtype=torch.int32,
                       device=state[0].device)
    with torch.no_grad():
        again = blend3d_fwd(*args, work=work)
    if not all(torch.equal(a, b) for a, b in zip(again, state)):
        raise AssertionError(f"phase 8: K5 on {label} gave another state "
                             f"than its training-mode launch")
    fwd = check_blend3d(tag, f"K5 on {label}", args, state, work)
    flip = fwd["flip_mask"]
    g = [torch.where(flip if t.dim() == 2 else flip[..., None], 0.0, t)
         for t in g]
    kw = dict(chunk=args[9], tile_cap=args[10])
    bwd = check_blend3d_grads(
        tag, f"K6 on {label}", blend3d_bwd(*args[:9], state, walk, *g, **kw),
        blend3d_plain_vjp(*args[:9], *g, **kw))
    return fwd, bwd, work


def check_blend3d_grads(tag, label, dk, dp) -> dict:
    """K6's gradients (conic, centre, colours, depth, opacity) against the
    plain VJP's, each input's max-normalised; raises past GRAD."""
    rtol, atol = GRAD
    res = {}
    for name, a, b in zip(("conic", "center", "colors", "depth", "opac"),
                          dk, dp):
        scale = float(b.abs().max()) + 1e-30
        err = (a - b).abs() / scale
        res[name] = {"max_norm_err": float(err.max()), "scale": scale,
                     "bad": int((err > atol + rtol * b.abs() / scale).sum()),
                     "finite": bool(torch.isfinite(a).all())}
    log(f"[{tag}] {label}: max normalised |err| per input "
        + json.dumps({k: v["max_norm_err"] for k, v in res.items()})
        + f", entries outside rtol {rtol} atol {atol}: "
        + json.dumps({k: v["bad"] for k, v in res.items()}))
    if any(v["bad"] or not v["finite"] for v in res.values()) or \
            not any(v["scale"] > 1e-20 for v in res.values()):
        raise AssertionError(f"K6 disagrees with the plain VJP on {label}: "
                             f"{res}")
    return {"max_norm_err": max(v["max_norm_err"] for v in res.values()),
            "by_input": res,
            "max_abs_err": max(float((a - b).abs().max())
                               for a, b in zip(dk, dp))}


def blend3d_holds(inputs, cam, cfg) -> dict:
    """K5 against blend3d_plain on the card over the whole view, and K6
    against the plain autograd VJP with a cotangent from a seed (check_k6);
    one Blend3D forward and backward under
    torch.cuda.set_sync_debug_mode("error") (no host read); each pass's
    units and items and K6's items timed by their %globaltimer stamps,
    over the lists K5 laid out on the card; K5 (training mode, as Blend3D
    launches it, and serving mode), K6 and their plain versions timed with
    CUDA events (K6 with its outputs' zero fill), and their bounds on this
    view."""
    from d2dgs_torch.ops.cuda.blend import forward_layout, forward_work
    from d2dgs_torch.ops.cuda.raster3d import (SEG, UNIT, Blend3D,
                                               blend3d_bwd, blend3d_fwd,
                                               blend3d_plain_vjp,
                                               walk_buffers, walk_cap)
    from d2dgs_torch.ops.raster3d import blend3d_inputs, blend3d_plain
    dev = inputs[0].device
    label = f"the {cam.H}x{cam.W} flow view"
    with torch.no_grad():
        _, args = blend3d_inputs(*inputs, cam, cfg=cfg)
    nt, n_pairs = args[6].shape[0], args[5].shape[0]
    walk = walk_buffers(nt, n_pairs, args[0].shape[0], dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.no_grad():
        out = blend3d_fwd(*args, walk=walk, stats=stats)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(12)
    g = [torch.randn(o.shape, generator=gen, device=dev) for o in out]
    fwd, bwd, work = check_k6("phase 8", label + ", a cotangent from a "
                              "seed", args, out, walk, g)
    g = [torch.where(fwd["flip_mask"] if t.dim() == 2
                     else fwd["flip_mask"][..., None], 0.0, t) for t in g]
    # one Blend3D forward and backward reading nothing back
    xs = [a.clone().requires_grad_() for a in args[:5]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = torch.autograd.grad(Blend3D.apply(*xs, *args[5:]), xs, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError("phase 8: Blend3D's gradients are not finite")
    del xs, grads
    # per-unit and per-item timers over the lists K5 laid out on the card
    rep = {}
    unit_ns = torch.zeros((forward_work(nt, n_pairs)[2], 2),
                          dtype=torch.int64, device=dev)
    item_ns = torch.zeros((walk.grid_items, 2), dtype=torch.int64,
                          device=dev)
    k6_ns = torch.zeros_like(item_ns)
    k6_stats = torch.zeros(2, dtype=torch.int64, device=dev)
    kw = dict(chunk=args[9], tile_cap=args[10])
    with torch.no_grad():
        blend3d_fwd(*args, walk=walk, unit_ns=unit_ns, item_ns=item_ns,
                    report=rep)
        blend3d_bwd(*args[:9], out, walk, *g, stats=k6_stats, item_ns=k6_ns,
                    **kw)
    torch.cuda.synchronize()
    items, units = forward_layout(rep)
    c = torch.clamp(args[7], max=walk_cap(args[9], args[10])).long()
    t, sg = items.long().unbind(1)
    unit_tile, unit_k = units.long().unbind(1)
    fwd_walk = torch.clamp(work[:, 0].amax(dim=1).long()[t] - sg * SEG, 0,
                           SEG)
    tile_walk = walk.n_walk.amax(dim=1).long()
    rep_a = item_report("phase 8", "K5 pass A", unit_ns[:units.shape[0]],
                        unit_tile, torch.clamp(c[unit_tile] - unit_k * UNIT,
                                               0, UNIT), c)
    rep_b = item_report("phase 8", "K5 pass B", item_ns[:items.shape[0]], t,
                        fwd_walk, c)
    rep_6 = item_report("phase 8", "K6", k6_ns[:items.shape[0]], t,
                        torch.clamp(tile_walk[t] - sg * SEG, 0, SEG), c)
    with torch.no_grad():
        k5_ms = cuda_ms(lambda: blend3d_fwd(*args, walk=walk), reps=20)
        k5_serve_ms = cuda_ms(lambda: blend3d_fwd(*args), reps=20)
        k6_ms = cuda_ms(lambda: blend3d_bwd(*args[:9], out, walk, *g, **kw),
                        reps=20)
        plain_ms = cuda_ms(lambda: blend3d_plain(*args), reps=3)
    plain_vjp_ms = cuda_ms(lambda: blend3d_plain_vjp(*args[:9], *g, **kw),
                           reps=3)
    b5, b6 = blend3d_bound(args, work), blend3d_bound(args, work,
                                                      walk.n_walk)
    tests, refused = int(stats[1]), int(stats[2])
    res = {"pairs": n_pairs, "fwd_check": {k: v for k, v in fwd.items()
                                           if k != "flip_mask"},
           "bwd_check": bwd, "k5_ms": k5_ms, "k5_serve_ms": k5_serve_ms,
           "k6_ms": k6_ms, "k5_plain_ms": plain_ms,
           "k6_plain_ms": plain_vjp_ms, "k5_bound": b5, "k6_bound": b6,
           "busiest_tile_pairs": int(args[7].max()),
           "items": int(items.shape[0]), "units": int(units.shape[0]),
           "grid_items": rep["grid_items"], "grid_units": rep["grid_units"],
           "pass_a_evaluations": int(stats[0]),
           "cull_tests": tests, "cull_refused": refused,
           "cull_share": refused / max(tests, 1),
           "k6_cull_share": int(k6_stats[1]) / max(int(k6_stats[0]), 1),
           "busiest_item_pairs": int(torch.clamp(c[t] - sg * SEG, 0,
                                                 SEG).max()),
           "multi_segment_tiles": fwd["multi_segment_tiles"],
           "scratch_bytes": rep["scratch_bytes"],
           "pass_a": rep_a, "pass_b": rep_b, "k6_items": rep_6,
           "sync_free": True}
    log(f"[phase 8] K5/K6 on {label} ({n_pairs} pairs, busiest tile "
        f"{res['busiest_tile_pairs']}, {res['multi_segment_tiles']} tiles "
        f"of more than one segment): {res['units']} units and "
        f"{res['items']} items; pass A {res['pass_a_evaluations']} "
        f"evaluations, culled {refused} of {tests} (pair, warp) tests "
        f"({res['cull_share']:.3f}); K5 {k5_ms:.4f} ms in training mode, "
        f"{k5_serve_ms:.4f} serving (plain {plain_ms:.2f}), bound "
        f"{b5['bound_ms']:.4f} ms by {b5['bound_by']} ({b5['n_eval']:.0f} "
        f"evaluations, {b5['n_blend']:.0f} blends); K6 {k6_ms:.4f} ms (plain "
        f"VJP {plain_vjp_ms:.2f}), bound {b6['bound_ms']:.4f} ms by "
        f"{b6['bound_by']} ({b6['n_eval']:.0f} re-walked pairs), culled "
        f"{res['k6_cull_share']:.3f}; slowest items: pass A "
        f"{rep_a['slowest_us']:.1f} us, pass B {rep_b['slowest_us']:.1f}, K6 "
        f"{rep_6['slowest_us']:.1f}; Blend3D forward and backward under "
        f"sync debug mode 'error': no host read")
    return res


def phase_8(dev, card, res6) -> dict:
    """The optical-flow training path at full width, through the CLI."""
    from d2dgs_torch import cli
    from d2dgs_torch.data.flow import load_flow
    from d2dgs_torch.io.checkpoint import load_train_state
    from d2dgs_torch.ops import raster3d
    from d2dgs_torch.train.trainer import (init_train_state,
                                           main_stage_step, mlp_trainable,
                                           optical_flow_loss)
    t_start = time.time()
    scene, start_ckpt, cfg = res6["scene"], res6["start_ckpt"], res6["cfg"]
    gauss, nodes, deform_cfg = full_scene(dev)
    if cfg.node_cfg != deform_cfg.node:
        raise AssertionError("the scene's nodes are not the CLI's")
    args = cli._base_parser("train", True).parse_args(
        ["-s", str(scene), "-m", "unused", *CLI_FLAGS])
    info = cli._load_scene(args, dev)
    cams = [s.camera for s in info.train_cameras]
    paths = write_flow_files(scene, gauss, nodes, deform_cfg, cams,
                             cfg.raster)
    n_small = sum(np.load(p, mmap_mode="r").shape[0] == FLOW_SMALL
                  for p in paths.values())
    log(f"[phase 8] {len(paths)} flow files ({n_small} at {FLOW_SMALL}x"
        f"{FLOW_SMALL}) written in {time.time() - t_start:.1f} s")

    # ---- the flow term of the unperturbed scene against its own target
    k = 1
    cam1, cam2 = cams[k], cams[flow_target(k)]
    flow, mask = load_flow(paths[k], cam1.H, cam1.W)
    gt = torch.as_tensor(info.train_cameras[k].gt(np.zeros(3, np.float32)),
                         device=dev)
    pw = float(np.clip(np.cos(abs(float(cam1.time) - float(cam2.time))
                              * np.pi / 2.0), 0.2, 1.0))
    with torch.no_grad():
        self_term = float(optical_flow_loss(
            gauss, nodes, cam1, cam2, torch.as_tensor(flow, device=dev),
            torch.as_tensor(mask, device=dev), pw, gt, gt, cfg,
            {"step": CLI_START}))
        solid = int((scene_flow(gauss, nodes, deform_cfg, cam1, cam2,
                                cfg.raster, CLI_START)["alpha"] > 0.9).sum())
    if not self_term < 1e-6 or solid < MIN_SOLID:
        raise AssertionError(f"phase 8: flow term against its own target "
                             f"{self_term} on {solid} solid pixels")

    # ---- rasterize_3dgs: the card against the CPU on a crop, K5 and K6
    # against their plain versions over the whole view, both routes timed
    inputs = flow_raster_inputs(gauss, nodes, deform_cfg, cam1, cam2,
                                CLI_START)
    crop = flow_crop_check(dev, inputs, cam1, cfg.raster)
    holds = blend3d_holds(inputs, cam1, cfg.raster)
    xs = [a.clone().requires_grad_(True) for a in inputs]
    w = torch.rand((cam1.H, cam1.W, 5), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))

    def fwd(plain):
        with torch.no_grad():
            flow_raster_route(plain, inputs, cam1, cfg.raster)

    def fwd_bwd(plain):
        out = flow_raster_route(plain, xs, cam1, cfg.raster)
        torch.autograd.grad(torch.sum(torch.cat(out, -1) * w), xs)
    raster3d.WALK_COUNTS.update(renders=0, chunks=0)
    fwd(False)
    fwd_bwd(False)
    if raster3d.WALK_COUNTS != {"renders": 0, "chunks": 0}:
        raise AssertionError(f"phase 8: the kernel route walked the plain "
                             f"blend: {raster3d.WALK_COUNTS}")
    fwd(True)
    chunks_one = raster3d.WALK_COUNTS["chunks"]
    # in turns (plain, kernel, kernel, plain), 5 calls each
    route_ms = {"kernel": [], "plain": []}
    for route in ("plain", "kernel", "kernel", "plain"):
        route_ms[route].append(
            (cuda_ms(lambda: fwd(route == "plain"), reps=5),
             cuda_ms(lambda: fwd_bwd(route == "plain"), reps=5)))
    (fwd_ms, fwd_bwd_ms), (plain_fwd_ms, plain_fwd_bwd_ms) = (
        np.mean(route_ms[r], axis=0).tolist() for r in ("kernel", "plain"))
    del xs
    log(f"[phase 8] rasterize_3dgs at {cam1.H}x{cam1.W} ({card}), means of "
        f"two turns: through K5/K6 forward {fwd_ms:.2f} ms, forward + "
        f"backward {fwd_bwd_ms:.2f} ms; through the plain walk forward "
        f"{plain_fwd_ms:.2f} ms, forward + backward {plain_fwd_bwd_ms:.2f} "
        f"ms ({chunks_one} chunks of {cfg.raster.chunk} pairs); turns "
        + json.dumps(route_ms) + f"; the card against the CPU on "
        f"{CROP_TILES}x{CROP_TILES} tiles ({crop['splats']} splats): max "
        f"|d image| {crop['image']:.3g}, |d alpha| {crop['alpha']:.3g}, "
        f"|d depth| {crop['depth']:.3g}, radii equal")

    # ---- one main-stage step with and without the flow term
    def start_state():
        template = init_train_state(cfg, *cli._init_points(info, cfg, 0),
                                    device=dev)
        return load_train_state(str(start_ckpt), template)[0]
    sched = dict(phase4_schedules(cfg, 1)[0], step=CLI_START,
                 lambda_optical=0.1)
    sample = (cam2, torch.as_tensor(flow, device=dev),
              torch.as_tensor(mask, device=dev), pw)
    cam_gt = (cam1, gt)
    step_ms, mlps, peak, k6_call = {}, {}, {}, {}
    for flow_loss in (False, True):
        state = start_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # K6's inputs and cotangent in the step with the flow term
        spy = kernel_inputs("blend3d_bwd", lambda a, k: k6_call.update(
            args=a, kw=k), module="raster3d") if flow_loss \
            else contextlib.nullcontext()
        start.record()
        with spy:
            state, _ = main_stage_step(state, *cam_gt, cfg, sched,
                                       flow_sample=sample,
                                       flow_loss=flow_loss)
        end.record()
        torch.cuda.synchronize()
        peak[flow_loss] = (torch.cuda.max_memory_allocated() - base) / 1e9
        mlps[flow_loss] = {k: v.detach().clone()
                           for k, v in mlp_trainable(state.nodes).items()}
        # a warmed-up time of each, state by state
        step_ms[flow_loss] = cuda_ms(lambda: main_stage_step(
            state, *cam_gt, cfg, sched, flow_sample=sample,
            flow_loss=flow_loss), reps=3)
        del state
    diff = sum(float((mlps[True][k] - mlps[False][k]).abs().sum())
               for k in mlps[True])
    if not diff > 0.0:
        raise AssertionError("phase 8: the flow term did not change the "
                             "deform MLP's update")
    # K5 and K6 against their plain versions on that step's own inputs and
    # flow-loss cotangent
    a, kw = k6_call["args"], k6_call["kw"]
    if not any(bool(t.any()) for t in a[11:14]):
        raise AssertionError("phase 8: the flow term's cotangent is zero")
    own_fwd, own, _ = check_k6(
        "phase 8", "the flow step's view, its own flow-loss cotangent",
        (*a[:9], kw["chunk"], kw["tile_cap"]), a[9], a[10], a[11:14])
    own["k5_flipped"] = own_fwd["flipped"]
    del a, k6_call
    del gauss, nodes, inputs, mlps
    torch.cuda.empty_cache()
    log(f"[phase 8] main-stage step ({card}): {step_ms[False]:.2f} ms "
        f"without the flow term, {step_ms[True]:.2f} ms with it; peak "
        f"memory above the state {peak[False]:.2f} / {peak[True]:.2f} GB; "
        f"the flow term moved the deform MLP's update by {diff:.4g} "
        f"(sum of |d|)")

    # ---- cli train --resume with the flow files
    model = scene.parent / "model_flow"
    last = CLI_START + FLOW_STEPS - 1
    reset_counts()
    raster3d.WALK_COUNTS.update(renders=0, chunks=0)
    t0 = time.time()
    # the motion-mask term off, so each step renders once through K1
    rep = run_cli(["train", "-s", str(scene), "-m", str(model), *CLI_FLAGS,
                   "--no_motion_mask_loss",
                   "--resume", str(start_ckpt), "--iterations",
                   str(last - 1), "--test_iterations", "-1",
                   "--save_iterations", "-1", "--log_every", "10"])
    cli_s = time.time() - t0
    counts = launch_counts()
    walk = dict(raster3d.WALK_COUNTS)
    if len(rep["step_ms"]) != FLOW_STEPS or rep["flow_steps"] != FLOW_STEPS:
        raise AssertionError(f"phase 8: {len(rep['step_ms'])} steps, "
                             f"{rep['flow_steps']} with a flow sample; "
                             f"expected {FLOW_STEPS} of each")
    if (counts["blend_fwd"], counts["blend_bwd"], counts["blend3d_fwd"],
            counts["blend3d_bwd"]) != (FLOW_STEPS,) * 4 or \
            counts["blend_dense_fwd"] or counts["blend_dense_bwd"]:
        raise AssertionError(f"phase 8 launches {counts}: expected one K1, "
                             f"one K2, one K5 and one K6 per step, no "
                             f"K3/K4")
    if walk != {"renders": 0, "chunks": 0}:
        raise AssertionError(f"phase 8: the plain blend walked {walk} in "
                             f"the flow steps on the card")
    if not all(np.isfinite(rep["loss"])):
        raise AssertionError(f"phase 8: non-finite loss {rep['loss']}")
    with np.load(model / "ckpt.npz") as z:
        bad = [k for k in z.files if z[k].dtype.kind == "f"
               and not np.isfinite(z[k]).all()]
    if bad:
        raise AssertionError(f"phase 8: non-finite {bad[:5]} after training")
    res = {"launches": counts, "step_ms": rep["step_ms"],
           "flow_step_ms": float(np.mean(rep["step_ms"][1:])),
           "flow_step_ms_median": float(np.median(rep["step_ms"][1:])),
           "l1": rep["loss"], "self_term": self_term, "solid_px": solid,
           "crop": crop, "raster3d_fwd_ms": fwd_ms,
           "raster3d_fwd_bwd_ms": fwd_bwd_ms,
           "raster3d_plain_fwd_ms": plain_fwd_ms,
           "raster3d_plain_fwd_bwd_ms": plain_fwd_bwd_ms,
           "raster3d_turns_ms": route_ms, "plain_chunks_one_view": chunks_one,
           "blend3d": holds, "k6_own_check": own,
           "step_ms_no_flow": step_ms[False], "step_ms_flow": step_ms[True],
           "peak_gb_no_flow": peak[False], "peak_gb_flow": peak[True],
           "mlp_update_diff": diff, "flow_files": len(paths),
           "flow_files_small": n_small, "cli_s": cli_s}
    log(f"[phase 8] cli train --resume with {len(paths)} flow files: "
        f"{FLOW_STEPS} steps, every one with the flow term; "
        f"{res['flow_step_ms']:.2f} ms per step (mean of steps 2-"
        f"{FLOW_STEPS}, median {res['flow_step_ms_median']:.2f}; phase 6 "
        f"without flow files {res6['train_step_ms']:.2f}) ({card}); "
        f"plain chunks walked {walk['chunks']}; L1 "
        f"{rep['loss'][0]:.5f} -> {rep['loss'][-1]:.5f}; launches {counts}; "
        f"flow term of the unperturbed scene against its own target "
        f"{self_term:.3g} ({solid} solid pixels); phase 8 "
        f"{time.time() - t_start:.1f} s")
    return res


# ----------------------------------------------------------------------
# phase 9: the other deformation fields, DQB skinning and `cli edit`, on
# phase 6's D-NeRF scene (32 train, 4 test views at 800x800): `cli train
# --deform_type hash|mlp|static` from the scene's initial cloud with the
# default TrainConfig and HashConfig (capacity 200,000; 12 levels of 2^19
# entries), only the depth cut, and with it the deform warm-up: the
# default holds the field still for 3,000 of 80,000 steps while the
# Gaussians fit; here the field trains in the last FIELD_LIVE steps.  A
# fresh field under the default deform LR (Adam, 8e-4) moves the
# Gaussians quadratically in its steps: trained from step 1, it moved
# every Gaussian of this scene out of view by step 22 on an H100.  The
# DQB warp on phase 3's serving scene; `cli edit` on phase 6's trained
# node model
HASH_STEPS = 60         # main-stage steps of `cli train --deform_type hash`
MLP_STEPS = 20
STATIC_STEPS = 10
FIELD_LIVE = 5          # the last steps of each run, the field trained
EDIT_FRAMES = 8
EDIT_ARGS = ["--time", "0.5", "--drag=0.15,0.05,0.1", "--arc=0.0,0.12,0.0",
             "--n_frames", str(EDIT_FRAMES), "--arap_iters", "3"]
EDIT_TOL = 1e-4         # handles on their targets, anchors where they were
# the card's ARAP solve against the CPU's (float32 LU from two LAPACKs on a
# 1,024-node system; the scene spans ~2 units)
EDIT_CPU_TOL = 1e-3
# the DQB warp on the card against the CPU, on the Gaussians whose K
# nearest nodes are the same on both (the bfloat16 selection can flip a
# near tie); at most this share may differ
DQB_TOL = 1e-4
DQB_MAX_FLIPPED = 1e-3


def field_train(scene: Path, model: Path, deform_type: str, steps: int,
                spy=None) -> dict:
    """`cli train --deform_type <type>` for ``steps`` main-stage steps from
    the scene's initial cloud; returns the report, the launches and the
    checkpoint's counters.  With HASH_STEPS a test and a save iteration
    come last; ``spy`` keeps the blend backward's arguments."""
    test = (["--test_iterations", str(steps), "--save_iterations",
             str(steps)] if deform_type == "hash" else
            ["--test_iterations", "-1", "--save_iterations", "-1"])
    argv = ["train", "-s", str(scene), "-m", str(model), "--deform_type",
            deform_type, "--iterations", str(steps - 1), "--warm_up",
            str(steps - FIELD_LIVE + 1), "--log_every", "10", *test]
    reset_counts()
    ctx = (kernel_inputs("blend_bwd", spy) if spy is not None
           else contextlib.nullcontext())
    with ctx:
        rep = run_cli(argv)
    counts = launch_counts()
    with np.load(model / "ckpt.npz") as z:
        it, it_node = int(z["__iteration__"]), int(z["__iteration_node__"])
        bad = [k for k in z.files if z[k].dtype.kind == "f"
               and not np.isfinite(z[k]).all()]
    n_test = N_TEST if deform_type == "hash" else 0
    loss = rep.get("loss", [])
    log(f"[phase 9] {deform_type}: each step (ms, the field trained in "
        f"the last {FIELD_LIVE}) "
        + json.dumps([round(v, 1) for v in rep["step_ms"]]))
    if len(rep["step_ms"]) != steps or len(loss) != steps:
        raise AssertionError(f"phase 9 {deform_type}: {len(rep['step_ms'])} "
                             f"steps, {len(loss)} losses; expected {steps}")
    if (counts["blend_fwd"], counts["blend_bwd"]) != (steps + n_test, steps) \
            or counts["blend_dense_fwd"] or counts["blend_dense_bwd"]:
        raise AssertionError(f"phase 9 {deform_type}: launches {counts} over "
                             f"{steps} steps and {n_test} test views; "
                             f"expected one K1 and one K2 per step")
    if not np.isfinite(loss).all() or bad:
        raise AssertionError(f"phase 9 {deform_type}: non-finite loss or "
                             f"checkpoint arrays {bad[:5]}")
    return {"report": rep, "launches": counts, "iteration": it,
            "iteration_node": it_node,
            "step_ms": float(np.mean(rep["step_ms"][1:])),
            "step_ms_median": float(np.median(rep["step_ms"][1:])),
            "live_step_ms": float(np.mean(rep["step_ms"][-FIELD_LIVE:]))}


def initial_tables(scene: Path, dev) -> list:
    """The hash tables `cli train --deform_type hash` starts from: the
    same init_train_state, seed and cloud as its Trainer."""
    from d2dgs_torch import cli
    from d2dgs_torch.train.trainer import init_train_state
    args = cli._base_parser("train", True).parse_args(
        ["-s", str(scene), "-m", "unused", "--deform_type", "hash"])
    cfg = cli.config_from_args(args)
    info = cli._load_scene(args, dev)
    state = init_train_state(
        cfg, *cli._init_points(info, cfg, args.seed),
        torch.Generator().manual_seed(args.seed), device=dev)
    return [t.detach().cpu().numpy() for t in state.nodes.mlp["tables"]]


def hash_encode_ms(model: Path, dev) -> dict:
    """hash_encode's forward, and forward plus backward into the tables,
    on the trained hash model's own Gaussians (every capacity row, as
    the step runs it) at the step HASH_STEPS; and the backward of one
    level's gather through index_select (the module's) against advanced
    indexing, on that level's own indices."""
    from d2dgs_torch.models.hash_deform import (HashConfig, _corner_index,
                                                hash_encode)
    cfg = HashConfig()
    with np.load(model / "ckpt.npz") as z:
        xyz = torch.as_tensor(z["leaf:.gauss.xyz"], device=dev)
        tabs = [torch.as_tensor(z[f"leaf:.nodes.mlp['tables'][{lvl}]"],
                                device=dev).requires_grad_(True)
                for lvl in range(cfg.n_levels)]
    lo, hi = cfg.bbox
    x01 = torch.clamp((xyz - lo) / (hi - lo), 0.0, 1.0)
    n = x01.shape[0]
    gen = torch.Generator(device=dev).manual_seed(12)
    w = torch.randn((n, cfg.enc_dim), device=dev, generator=gen)
    with torch.no_grad():
        fwd = cuda_ms(lambda: hash_encode(tabs, cfg, x01, HASH_STEPS),
                      reps=10)

    def fwd_bwd():
        enc = hash_encode(tabs, cfg, x01, HASH_STEPS)
        torch.autograd.grad(torch.sum(enc * w), tabs)
    # level 0's gather alone, both ways
    res = cfg.resolution(0)
    lo0 = torch.clamp(torch.floor(x01 * res).to(torch.int64), 0, res - 1)
    corners = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1]
                            for i in range(8)], device=dev)
    tidx = _corner_index(lo0[:, None, :] + corners[None], res,
                         cfg.table_size, 3)
    g8 = torch.randn((n, 8, cfg.n_features), device=dev, generator=gen)
    gather = {
        "index_select": lambda: torch.autograd.grad(torch.sum(
            torch.index_select(tabs[0], 0, tidx.reshape(-1)).reshape(
                n, 8, -1) * g8), tabs[0]),
        "advanced_indexing": lambda: torch.autograd.grad(torch.sum(
            tabs[0][tidx] * g8), tabs[0])}
    return {"fwd_ms": fwd, "fwd_bwd_ms": cuda_ms(fwd_bwd, reps=10),
            "points": n, "dead_rows": int((xyz == 0).all(-1).sum()),
            "gather_fwd_bwd_ms": {k: cuda_ms(f, reps=5)
                                  for k, f in gather.items()}}


def dqb_check(dev, card) -> dict:
    """The DQB warp of phase 3's scene (its MLP's local-rotation and warp
    heads raised from their near-zero init) on the card against the CPU,
    then four served 800x800 views, one K1 launch each."""
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models.nodes import NodeParams, cal_nn_weight, warp
    from d2dgs_torch.render.renderer import render
    gauss, nodes, deform_cfg = full_scene(dev)
    ncfg = dataclasses.replace(deform_cfg.node, skinning="dqb")
    if not (ncfg.mlp.local_frame and ncfg.skinning == "dqb"):
        raise AssertionError("phase 9: the DQB configuration is off")
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for head, std in (("local_rotation", 0.02), ("warp", 0.002)):
            w = nodes.mlp[head]["w"]
            w.copy_(torch.randn(w.shape, generator=gen).to(dev) * std)
    nodes_cpu = NodeParams(nodes.nodes.detach().cpu(),
                           nodes.node_radius.detach().cpu(),
                           nodes.node_weight.detach().cpu(),
                           copy.deepcopy(nodes.mlp).cpu(), nodes.alive.cpu())
    t = 0.6
    with torch.no_grad():
        outs = {}
        for where, n in (("cuda", nodes), ("cpu", nodes_cpu)):
            d_of = lambda a: a.detach().to(where)
            x, feat, mm = (d_of(gauss.xyz), d_of(gauss.feature),
                           d_of(gauss.motion_mask))
            d = warp(n, ncfg, x, torch.tensor(t, device=where), feature=feat,
                     motion_mask=mm)
            _, _, idx = cal_nn_weight(n, ncfg, x, feat)
            outs[where] = ({k: d[k].cpu() for k in
                            ("d_xyz", "d_rotation", "d_scaling")},
                           torch.sort(idx, dim=-1).values.cpu())
        del nodes_cpu
    same = torch.all(outs["cuda"][1] == outs["cpu"][1], dim=-1)
    alive = gauss.alive.cpu()
    flipped = int((~same & alive).sum())
    err = {k: float((outs["cuda"][0][k] - outs["cpu"][0][k])[same & alive]
                    .abs().max()) for k in outs["cuda"][0]}
    moved = float(outs["cuda"][0]["d_xyz"][alive].abs().max())
    if flipped > DQB_MAX_FLIPPED * int(alive.sum()) or \
            max(err.values()) > DQB_TOL or not moved > 1e-3:
        raise AssertionError(f"phase 9: DQB warp card vs CPU {err} on "
                             f"{int((same & alive).sum())} Gaussians, "
                             f"{flipped} with other neighbours; largest "
                             f"|d_xyz| {moved}")
    # ---- served views: the DQB warp, then the render ----
    cfg = RasterConfig()
    bg = torch.zeros(3, device=dev)
    cams = [orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=tv,
                         device=dev) for tv in (0.0, 0.25, 0.5, 0.75)]

    def serve(cam):
        d = warp(nodes, ncfg, gauss.xyz, cam.time, feature=gauss.feature,
                 motion_mask=gauss.motion_mask)
        return render(cam, gauss, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                      cfg=cfg)
    with torch.no_grad():
        reset_counts()
        for i, cam in enumerate(cams):
            out = serve(cam)
            torch.cuda.synchronize()
            if launch_counts()["blend_fwd"] != i + 1:
                raise AssertionError(f"phase 9: DQB view {i}: K1 launches "
                                     f"{launch_counts()}")
            if not bool(torch.isfinite(out.image).all()) or \
                    not float((out.alpha > 0).float().mean()) > 0:
                raise AssertionError(f"phase 9: DQB view {i} is empty or "
                                     f"not finite")
        counts = launch_counts()
        view_ms = cuda_ms(lambda: serve(cams[2]), reps=5)
        warp_ms = cuda_ms(lambda: warp(nodes, ncfg, gauss.xyz, cams[2].time,
                                       feature=gauss.feature,
                                       motion_mask=gauss.motion_mask),
                          reps=5)
    del gauss, nodes
    log(f"[phase 9] DQB warp ({int(alive.sum())} Gaussians, 1024 nodes, "
        f"t={t}): card against CPU max |err| " + json.dumps(err)
        + f" on the {int((same & alive).sum())} with the same neighbours "
        f"({flipped} differ by a near tie), largest |d_xyz| {moved:.4f}; "
        f"4 served 800x800 views, K1 launches {counts['blend_fwd']}; a "
        f"served DQB view {view_ms:.3f} ms, its warp {warp_ms:.3f} ms "
        f"({card})")
    return {"launches": counts, "err": err, "flipped": flipped,
            "view_ms": view_ms, "warp_ms": warp_ms}


def arap_determined(nbr: np.ndarray, handles: np.ndarray):
    """Of the editing graph's nodes (out-edges ``nbr`` [N, K]) with the
    rows of ``handles`` pinned: (free, determined) bool masks.  A node
    that reaches no handle along out-edges is free: the free nodes form
    closed sets, on which the global step's matrix has rows summing to 0,
    so it is singular and the solve's values there are arbitrary.  A node
    is determined when it reaches no free node (a handle's row is its
    own)."""
    n = nbr.shape[0]
    pinned = np.zeros(n, bool)
    pinned[handles] = True

    def reaches(targets):
        hit = targets.copy()
        while True:
            new = hit | (hit[nbr].any(1) & ~pinned)
            if (new == hit).all():
                return hit
            hit = new
    free = ~reaches(pinned)
    return free, ~reaches(free)


def edit_check(scene: Path, model: Path, dev, card) -> dict:
    """`cli edit` on phase 6's trained node model: one handle at a node,
    a drag with an arc, EDIT_FRAMES frames.  Checks one K1 per frame, the
    frames and GIF, finite solved nodes, handles and anchors on their
    targets and the card's solve against the CPU's on the nodes the
    handles determine.  Where some nodes reach no handle, the global
    step is singular (the reference's fault, ROADMAP.md section 3) and
    the solve may move them anywhere, so only then may a frame show
    nothing; its coverage is printed."""
    from PIL import Image

    from d2dgs_torch.edit import LapDeform
    with np.load(model / "ckpt_best.npz") as z:
        node = z["leaf:.nodes.nodes"][7, :3]
    handle = ",".join(f"{v:.6f}" for v in node)
    reset_counts()
    rep = run_cli(["edit", "-s", str(scene), "-m", str(model),
                   f"--handle={handle}", *EDIT_ARGS])
    counts = launch_counts()
    out = model / "edit"
    covered = [float((np.asarray(Image.open(out / f"frame_{f:04d}.png"))
                      > 0).any(-1).mean()) for f in range(EDIT_FRAMES)]
    hidx, rest = rep["handle_idx"], rep["rest_nodes"]
    anchors = hidx[rep["n_drag"]:]
    lap = LapDeform(rest, K=4, device="cpu")
    free, determined = arap_determined(lap.graph.nbr.numpy(), hidx)
    pinned = np.zeros(rest.shape[0], bool)
    pinned[hidx] = True
    sv = np.linalg.svd(np.where(pinned[:, None], np.eye(rest.shape[0]),
                                lap.graph.L.numpy().astype(np.float64)),
                       compute_uv=False)
    finite = all(np.isfinite(s).all() for s in rep["solved"])
    land, anchor_err, cpu_err, cpu_err_all, moved = 0.0, 0.0, 0.0, 0.0, []
    for hp, solved in zip(rep["handle_pos"], rep["solved"]):
        land = max(land, float(np.abs(solved[hidx] - hp).max()))
        anchor_err = max(anchor_err, float(np.abs(
            solved[anchors] - rest[anchors]).max()))
        diff = np.abs(solved - lap.deform_arap(hidx, hp, n_iters=3)[0]
                      .numpy()).max(-1)
        cpu_err = max(cpu_err, float(diff[determined].max()))
        cpu_err_all = max(cpu_err_all, float(diff.max()))
        moved.append(float(np.abs(solved - rest).max()))
    res = {"launches": counts, "frame_ms": float(np.mean(rep["frame_ms"][1:])),
           "solve_ms": float(np.mean(rep["solve_ms"][1:])),
           "handle_err": land, "anchor_err": anchor_err, "cpu_err": cpu_err,
           "cpu_err_all": cpu_err_all, "free_nodes": int(free.sum()),
           "sigma_min_over_max": float(sv[-1] / sv[0]),
           "determined_nodes": int(determined.sum()),
           "nodes": int(rest.shape[0]), "handles": int(rep["n_drag"]),
           "anchors": int(anchors.size), "covered": covered}
    log(f"[phase 9] cli edit: {res['nodes']} nodes, {res['handles']} "
        f"dragged and {res['anchors']} anchored, {EDIT_FRAMES} frames: "
        f"{res['frame_ms']:.2f} ms per edited frame, ARAP solve "
        f"{res['solve_ms']:.2f} ms (means of frames 2-{EDIT_FRAMES}, each "
        f"between two device synchronisations) ({card}); handles within "
        f"{land:.3g} of their targets, anchors within {anchor_err:.3g}; "
        f"{res['free_nodes']} nodes reach no handle (the global step's "
        f"matrix has sigma_min / sigma_max {res['sigma_min_over_max']:.3g}),"
        f" {res['determined_nodes']} are determined: the card's "
        f"solve within {cpu_err:.3g} of the CPU's on those, {cpu_err_all:.3g}"
        f" on all; solved nodes finite {finite}, each frame's largest node "
        f"move " + json.dumps([round(v, 4) for v in moved])
        + " and share of the view covered "
        + json.dumps([round(v, 4) for v in covered]) + f"; launches {counts}")
    if (counts["blend_fwd"], counts["blend_bwd"]) != (EDIT_FRAMES, 0):
        raise AssertionError(f"phase 9 edit: launches {counts}; expected "
                             f"one K1 per frame")
    if not (out / "edit.gif").exists() or not finite:
        raise AssertionError(f"phase 9 edit: gif "
                             f"{(out / 'edit.gif').exists()}, solved nodes "
                             f"finite {finite}")
    if land > EDIT_TOL or anchor_err > EDIT_TOL or cpu_err > EDIT_CPU_TOL:
        raise AssertionError(f"phase 9 edit: handles {land}, anchors "
                             f"{anchor_err} from their targets, card vs "
                             f"CPU {cpu_err} on the determined nodes")
    if not all(c < 1 for c in covered) or \
            (not free.any() and not all(c > 0 for c in covered)):
        raise AssertionError(f"phase 9 edit: frames cover {covered} of the "
                             f"view with {int(free.sum())} free nodes")
    return res


def phase_9(dev, card, res6) -> dict:
    """The deform types, DQB and `cli edit` at full width."""
    t_start = time.time()
    scene = res6["scene"]
    base = scene.parent
    # ---- (a) hash ----
    last_step = {}
    h = field_train(scene, base / "model_hash", "hash", HASH_STEPS,
                    spy=lambda a, k: last_step.update(args=a, kw=k))
    loss = h["report"]["loss"]
    if h["iteration_node"] != res6["cfg"].iterations_node_rendering or \
            h["iteration"] != HASH_STEPS + 1:
        raise AssertionError(f"phase 9 hash: the checkpoint's counters "
                             f"{h['iteration']}, {h['iteration_node']}: a "
                             f"stage-1 step ran")
    if not np.mean(loss[-10:]) < np.mean(loss[:10]):
        raise AssertionError(f"phase 9 hash: L1 did not fall: {loss}")
    init = initial_tables(scene, dev)
    with np.load(base / "model_hash" / "ckpt.npz") as z:
        tables = [z[f"leaf:.nodes.mlp['tables'][{lvl}]"]
                  for lvl in range(len(init))]
    still = [lvl for lvl in range(len(init))
             if np.array_equal(tables[lvl], init[lvl])]
    if still[:1] != [7] or still != list(range(7, 12)):
        raise AssertionError(f"phase 9 hash: levels unchanged {still}; "
                             f"expected 7-11 (the band mask at step "
                             f"{HASH_STEPS})")
    rep_r = run_cli(["render", "-s", str(scene), "-m",
                     str(base / "model_hash")])
    with open(base / "model_hash" / "results.json") as fh:
        hash_results = json.load(fh)
    meshes = run_cli(["mesh", "-s", str(scene), "-m",
                      str(base / "model_hash"), *CLI_MESH])["meshes"]
    if len(meshes) != 1 or meshes[0]["faces"] == 0:
        raise AssertionError(f"phase 9 hash: empty mesh {meshes}")
    # K1 and K2 against their plain versions on the last step's own
    # inputs and cotangent
    fs, pair_rank, tile_start, tile_count, gx, _, _, g, _ = last_step["args"]
    chunk = last_step["kw"]["chunk"]
    binning = launch_binning(pair_rank, tile_start, tile_count)
    top = int(tile_count.max())
    label = f"hash step {HASH_STEPS} (fullest tile {top} pairs)"
    # K2 on every tile: the fog's threshold flips gather in its fullest
    # tiles, so the flip share is judged over the view, as K1's is
    # (the fog's many pixels near T = 0.5 or 1e-4 flip by rounding: each
    # flip must be a threshold case of the band, none a done flip)
    with torch.no_grad():
        _, res_k1 = check_kernel(label, fs, binning, gx, chunk,
                                 tag="phase 9", band=True)
        res_k2 = check_backward(
            label + ", its own cotangent on every tile", fs, binning, gx,
            chunk, res_k1.pop("flip_mask"), g=g, tag="phase 9", batch=64,
            judged=True)
    res_k1["busiest_tile_pairs"] = res_k2["busiest_tile_pairs"] = top
    del last_step, fs, pair_rank, tile_start, tile_count, g, binning
    torch.cuda.empty_cache()
    enc = hash_encode_ms(base / "model_hash", dev)
    log(f"[phase 9] cli train --deform_type hash: {HASH_STEPS} main-stage "
        f"steps from the initial cloud, {h['step_ms']:.2f} ms per step "
        f"(mean of steps 2-{HASH_STEPS}, median {h['step_ms_median']:.2f}; "
        f"the last {FIELD_LIVE}, the field trained, {h['live_step_ms']:.2f})"
        f" ({card}); L1 {np.mean(loss[:10]):.5f} -> {np.mean(loss[-10:]):.5f} "
        f"(means of the first and last 10); launches {h['launches']}; "
        f"levels 7-11 unchanged, 0-5 moved; test PSNR "
        f"{hash_results['psnr']:.3f}, render {rep_r['view_ms']:.1f} ms per "
        f"view; mesh {meshes[0]['faces']} faces; hash_encode on the step's "
        f"{enc['points']} rows ({enc['dead_rows']} dead, at the origin): "
        f"forward {enc['fwd_ms']:.3f} ms, forward + backward "
        f"{enc['fwd_bwd_ms']:.3f} ms; level 0's gather forward + backward "
        + json.dumps(enc["gather_fwd_bwd_ms"]) + " ms")
    # ---- (b) mlp and static ----
    m = field_train(scene, base / "model_mlp", "mlp", MLP_STEPS)
    s = field_train(scene, base / "model_static", "static", STATIC_STEPS)
    log(f"[phase 9] cli train --deform_type mlp: {MLP_STEPS} steps, "
        f"{m['step_ms']:.2f} ms per step (median {m['step_ms_median']:.2f}, "
        f"the last {FIELD_LIVE} {m['live_step_ms']:.2f}); static: "
        f"{STATIC_STEPS} steps, {s['step_ms']:.2f} ms (median "
        f"{s['step_ms_median']:.2f}) ({card}); launches {m['launches']}, "
        f"{s['launches']}")
    # ---- (c) DQB ----
    dqb = dqb_check(dev, card)
    torch.cuda.empty_cache()
    # ---- (d) cli edit ----
    ed = edit_check(scene, base / "model", dev, card)
    launches = {k: h["launches"][k] + m["launches"][k] + s["launches"][k]
                for k in h["launches"]}
    log(f"[phase 9] phase 9 {time.time() - t_start:.1f} s")
    return {"launches_fields": launches, "launches_dqb": dqb["launches"],
            "launches_edit": ed["launches"], "fwd_check": res_k1,
            "bwd_check": res_k2, "hash_step_ms": h["step_ms"],
            "hash_live_step_ms": h["live_step_ms"],
            "mlp_step_ms": m["step_ms"], "mlp_live_step_ms": m["live_step_ms"],
            "static_step_ms": s["step_ms"],
            "hash_l1": [float(np.mean(loss[:10])), float(np.mean(loss[-10:]))],
            "hash_encode": enc, "dqb": {k: dqb[k] for k in (
                "err", "flipped", "view_ms", "warp_ms")},
            "edit": {k: ed[k] for k in (
                "frame_ms", "solve_ms", "handle_err", "anchor_err", "cpu_err",
                "cpu_err_all", "free_nodes", "determined_nodes",
                "sigma_min_over_max")},
            "hash_mesh_faces": meshes[0]["faces"],
            "hash_test_psnr": hash_results["psnr"]}


# ----------------------------------------------------------------------
# phase 10: the sharded path (d2dgs_torch/parallel/) on the phase-3 scene
# at t = 0.5: the tile exchange of SHARD_D ranks emulated in one process
# (the card is one: NCCL takes no two ranks on one GPU), each slab blended
# through K1 and K2 with the global-tile map; the sharded training step
# through NCCL at world size 1; the SIBR viewer serving phase 6's trained
# model; K1 and K2 timed with and without the map
SHARD_D = 4
SHARD_STEPS = 10
VIEWER_FRAMES = 8
REC_BYTES = 4 * (19 + 1) + 4   # a record's features and tile, its flag


def shard_view(gauss, nodes, deform_cfg, cam):
    """The rasterizer inputs of one view (the node warp, apply_deform, the
    SH colours), as render() builds them."""
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.models.gaussians import apply_deform
    from d2dgs_torch.utils.sh import sh_to_rgb
    d = deform_gaussians(nodes, deform_cfg, gauss.xyz, cam.time,
                         feature=gauss.feature, motion_mask=gauss.motion_mask)
    means, scales, quats, opac, sh = apply_deform(
        gauss, d["d_xyz"], d["d_rotation"], d["d_scaling"])
    dirs = means - cam.cam_center[None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-20)
    return (means, scales, quats, opac,
            sh_to_rgb(gauss.active_sh_degree, sh, dirs), gauss.alive)


def emulate_exchange(view, cam, cfg, D: int) -> dict:
    """The sharded render's pipeline for D ranks in one process: each
    shard's preprocess and records (``_emit_records``), the exchange by
    indexing (what rank e receives is block e of every source), each
    slab's merge (``_sort_records``) and K1's arguments (``slab_inputs``);
    and the whole grid's binning of the same per-Gaussian values (the
    shards' preprocess concatenated), which the stitched slabs must
    reproduce."""
    from d2dgs_torch.ops.binning import bin_gaussians
    from d2dgs_torch.ops.projection import Preprocessed, preprocess, tile_grid
    from d2dgs_torch.ops.tiled_raster import pack_features
    from d2dgs_torch.parallel.gauss_shard import (NFEAT, _emit_records,
                                                  _sort_records,
                                                  shard_gaussians,
                                                  slab_inputs)
    gx, gy = tile_grid(cam.H, cam.W)
    num_tiles = gx * gy
    my_tiles = -(-num_tiles // D)
    preps, feats, opcs = [], [], []
    for d in range(D):
        means, scales, quats, opac, colors, alive = shard_gaussians(D, d, view)
        prep = preprocess(means, scales, quats, cam)
        valid = prep.valid & alive
        prep = prep._replace(valid=valid,
                             radius=torch.where(valid, prep.radius, 0))
        opc = torch.where(valid, opac, 0.0)
        preps.append(prep)
        opcs.append(opc)
        feats.append(torch.cat([prep.T.reshape(-1, 9), prep.center,
                                prep.normal, colors, opc[:, None],
                                prep.depth[:, None]], dim=-1))
    counts = torch.stack([
        _emit_records(p, None, gx, gy, D, cfg, 0, counts_only=True,
                      opacity=o) for p, o in zip(preps, opcs)])  # [src,dst]
    cap = -(-int(counts.max()) // 256) * 256
    blocks = [_emit_records(p, f, gx, gy, D, cfg, cap, opacity=o)
              for p, f, o in zip(preps, feats, opcs)]
    overflow = int(sum(int(b[2]) for b in blocks))
    slabs = []
    for e in range(D):
        recs = torch.stack([b[0][e] for b in blocks]).reshape(-1, NFEAT + 1)
        ok = torch.stack([b[1][e] for b in blocks]).reshape(-1)
        s_feat, s_ok, start, count, glob = _sort_records(
            recs, ok, my_tiles, num_tiles, D, e)
        slabs.append((slab_inputs(s_feat, s_ok, start, count, glob, gx, gy,
                                  cfg), s_feat[:, 18]))
    prep = Preprocessed(*(torch.cat([p[i] for p in preps])
                          for i in range(len(preps[0]))))
    opc = torch.cat(opcs)
    b = bin_gaussians(prep, gx, gy, cfg, opacity=opc)
    fs = pack_features(prep.T, prep.center, prep.normal,
                       torch.cat([f[:, 14:17] for f in feats]),
                       opc)[b.order.long()].contiguous()
    return {"counts": counts.cpu().numpy(), "cap": cap, "overflow": overflow,
            "slabs": slabs, "grid_x": gx, "whole": (fs, b),
            "whole_depth": prep.depth[b.order.long()]}


def stitched_check(ex, cfg, whole_state) -> dict:
    """The slabs' K1 states stitched into the grid against the whole
    grid's K1 state: pair by pair, each slab tile's list against the whole
    grid's (the same rows, or a reorder among equal depths: a depth tie
    between shards), then the pixels whose state differs, each in a tile
    with a tie reorder or not (a fault)."""
    from d2dgs_torch.ops.cuda.blend import blend_fwd
    fs, b = ex["whole"]
    w_start = b.tile_start.long()
    w_count = torch.clamp_max(b.tile_count, cfg.tile_cap).long()
    n_tie_tiles = n_diff_tiles = diff_px = tie_px = 0
    for (args, depth_s) in ex["slabs"]:
        feats, _, start, count, gx, _, glob = args
        sk = blend_fwd(*args[:6], gtile=glob)
        live = glob < w_count.numel()
        g = glob.long()[live]
        cnt = count.long()[live]
        if not torch.equal(cnt, w_count[g]):
            raise AssertionError("phase 10: a slab's tile counts differ "
                                 "from the whole grid's")
        tile = torch.repeat_interleave(torch.arange(cnt.numel(),
                                                    device=cnt.device), cnt)
        j = torch.arange(tile.numel(), device=cnt.device) - (
            torch.cumsum(cnt, 0) - cnt)[tile]
        srow = start.long()[live][tile] + j
        wrow = b.pair_rank.long()[w_start[g][tile] + j]
        same = (feats[srow] == fs[wrow]).all(dim=-1)
        same_depth = depth_s[srow] == ex["whole_depth"][wrow]
        if not bool(same_depth.all()):
            raise AssertionError("phase 10: a slab tile's depth order "
                                 "differs from the whole grid's")
        bad_tile = torch.zeros(cnt.numel(), dtype=torch.bool,
                               device=cnt.device)
        bad_tile[tile[~same]] = True      # reordered within equal depths
        n_tie_tiles += int(bad_tile.sum())
        px = (sk[live] != whole_state[g]).any(dim=1)          # [t, PIX]
        diff_px += int(px.sum())
        tie_px += int(px[bad_tile].sum())
        n_diff_tiles += int(px.any(dim=1).sum())
    if diff_px != tie_px:
        raise AssertionError(f"phase 10: {diff_px - tie_px} stitched pixels "
                             f"differ from the whole grid outside depth "
                             f"ties")
    return {"diff_pixels": diff_px, "depth_tie_pixels": tie_px,
            "tie_tiles": n_tie_tiles, "diff_tiles": n_diff_tiles}


def clone_state(state):
    """An independent copy of a TrainState (the generator aside)."""
    from d2dgs_torch.parallel.gauss_train import _map_gauss
    from d2dgs_torch.train.optim import AdamState
    from d2dgs_torch.train.trainer import (NODE_FIELDS, mlp_trainable,
                                           with_node_trainable)
    adam = lambda o: AdamState({k: v.clone() for k, v in o.mu.items()},
                               {k: v.clone() for k, v in o.nu.items()},
                               o.count.clone())
    nodes = with_node_trainable(
        state.nodes, {k: getattr(state.nodes, k).detach().clone()
                      for k in NODE_FIELDS},
        {k: v.detach().clone() for k, v in mlp_trainable(state.nodes).items()})
    return _map_gauss(state, lambda x: x.clone())._replace(
        nodes=nodes, node_opt=adam(state.node_opt),
        mlp_opt=adam(state.mlp_opt))


def sharded_steps(dev, card, cfg, tmp: Path) -> dict:
    """SHARD_STEPS sharded main-stage steps through NCCL at world size 1
    (a file store), the slab blend's map live, each from the state the
    port's main_stage_step starts from, with the same draws: the loss to
    rtol 2e-4, no overflow; each step timed against main_stage_step's."""
    import torch.distributed as dist
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models import regularizers as R
    from d2dgs_torch.parallel import (make_mesh2d, shard_gauss_state,
                                      sharded_train_step,
                                      suggest_exchange_cap)
    from d2dgs_torch.parallel.multihost import maybe_init_distributed
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import main_stage_step
    from d2dgs_torch.utils.quaternion import quat_normalize
    maybe_init_distributed("cuda", init_method=f"file://{tmp / 'store'}",
                           world_size=1, rank=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"phase 10: backend {dist.get_backend()}")
        mesh = make_mesh2d(1, 1)
        gauss, nodes, deform_cfg = full_scene(dev)
        cam = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=0.5,
                           device=dev)
        gt = scene_render(gauss, nodes, deform_cfg, cam, cfg)
        perturb(gauss, seed=6)
        tcfg = TrainConfig(gaussian_capacity=gauss.capacity)
        state = training_state(gauss, nodes, seed=5)
        g = state.gauss
        with torch.no_grad():
            cap = suggest_exchange_cap(
                mesh.gauss_group, [cam], g.xyz, g.get_scaling,
                quat_normalize(g.rotation, eps=1e-12), g.alive, tcfg.raster,
                margin=2.0)
        scheds = phase4_schedules(tcfg, SHARD_STEPS)
        gen = torch.Generator().manual_seed(12)
        rows, counts = [], {f.__name__: 0 for f in kernel_wrappers()}
        for i, sched in enumerate(scheds):
            draws = R.arap_draws(gen, nodes.nodes.shape[0])
            sh = shard_gauss_state(mesh, clone_state(state))
            reset_counts()
            sh, m, sh_ms = synced_ms_pair(lambda: sharded_train_step(
                sh, [cam], gt[None], sched, tcfg, mesh, cap,
                arap_draws=draws))
            c = launch_counts()
            counts = {k: counts[k] + c[k] for k in counts}
            if (c["blend_fwd"], c["blend_bwd"]) != (1, 1):
                raise AssertionError(f"phase 10 step {i}: launches {c}")
            state, mr, ref_ms = synced_ms_pair(lambda: main_stage_step(
                state, cam, gt, tcfg, sched, arap_draws=draws))
            loss, ref = float(m["loss"]), float(mr["loss"])
            rows.append((loss, ref, sh_ms, ref_ms))
            if int(m["overflow"]) or not abs(loss - ref) <= 2e-4 * abs(ref):
                raise AssertionError(f"phase 10 step {i}: sharded loss "
                                     f"{loss} overflow {int(m['overflow'])}, "
                                     f"main_stage_step {ref}")
            log(f"[phase 10] sharded step {i}: L1 {loss:.6f} (main_stage_step"
                f" {ref:.6f}), {sh_ms:.2f} ms (main_stage_step "
                f"{ref_ms:.2f} ms)")
    finally:
        dist.destroy_process_group()
    sh_ms = float(np.mean([r[2] for r in rows[1:]]))
    ref_ms = float(np.mean([r[3] for r in rows[1:]]))
    log(f"[phase 10] NCCL world size 1, exchange cap {cap}: sharded step "
        f"{sh_ms:.2f} ms, main_stage_step {ref_ms:.2f} ms (means of steps "
        f"2-{SHARD_STEPS}, each between two synchronisations) ({card}); "
        f"max |rel loss diff| "
        f"{max(abs(r[0] - r[1]) / abs(r[1]) for r in rows):.3g}")
    return {"launches": counts, "step_ms": sh_ms, "ref_step_ms": ref_ms,
            "exchange_cap": cap, "l1": [r[0] for r in rows]}


def synced_ms_pair(fn):
    """(the two results of fn(), wall ms between two synchronisations)."""
    (a, b), ms = synced_ms(fn)
    return a, b, ms


def viewer_frames(dev, card, res6) -> dict:
    """A loopback SIBR client against phase 6's trained model through
    Trainer.attach_viewer: VIEWER_FRAMES 800x800 frames on an orbit (the
    client holds training until its last), each one K1; the last frame's
    bytes against the same view rendered directly."""
    import socket
    import threading
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.io.checkpoint import load_train_state
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train.trainer import Trainer
    from d2dgs_torch.viewer.network import _camera_from_message
    tcfg = res6["cfg"]
    pts = np.random.RandomState(0).normal(size=(4096, 3)).astype(
        np.float32) * 0.3
    cam0 = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, device=dev)
    tr = Trainer(tcfg, [cam0], [np.zeros((800, 800, 3), np.float32)], pts,
                 np.full_like(pts, 0.5), device=dev)
    tr.state, _, _ = load_train_state(
        str(res6["scene"].parent / "model" / "ckpt.npz"), tr.state)
    srv = tr.attach_viewer(port=0)
    msgs = []
    for k in range(VIEWER_FRAMES):
        cam = orbit_camera(0.3 + 0.1 * k, 0.25, 4.0, fov=0.69, H=800, W=800,
                           device="cpu")
        view = cam.w2c.numpy().T.copy()
        view[:, 1] *= -1
        view[:, 2] *= -1
        msgs.append({"resolution_x": 800, "resolution_y": 800,
                     "train": k == VIEWER_FRAMES - 1, "fov_x": 0.69,
                     "fov_y": 0.69, "z_near": 0.01, "z_far": 100.0,
                     "keep_alive": True, "scaling_modifier": 1.0,
                     "time": k / VIEWER_FRAMES,
                     "view_matrix": view.reshape(-1).tolist(),
                     "view_projection_matrix": np.eye(4).reshape(-1).tolist()})
    got = {"frames": [], "ms": []}

    def client():
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        for msg in msgs:
            payload = json.dumps(msg).encode()
            t0 = time.perf_counter()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            buf = b""
            while len(buf) < 800 * 800 * 3:
                buf += c.recv(800 * 800 * 3 - len(buf))
            n = int.from_bytes(c.recv(4), "little")
            c.recv(n)
            got["ms"].append((time.perf_counter() - t0) * 1e3)
            got["frames"].append(buf)
        c.close()

    reset_counts()
    th = threading.Thread(target=client)
    th.start()
    deadline = time.time() + 120.0
    while th.is_alive() and time.time() < deadline:
        tr._poll_viewer()
        time.sleep(0.001)
    th.join(timeout=10)
    counts = launch_counts()
    srv.close()
    if len(got["frames"]) != VIEWER_FRAMES or \
            counts["blend_fwd"] != VIEWER_FRAMES:
        raise AssertionError(f"phase 10 viewer: {len(got['frames'])} frames, "
                             f"launches {counts}")
    cam = _camera_from_message(msgs[-1], dev)
    g = tr.state.gauss
    with torch.no_grad():
        d = deform_gaussians(tr.state.nodes, tcfg.deform_cfg, g.xyz, cam.time,
                             feature=g.feature, motion_mask=g.motion_mask)
        img = render(cam, g, torch.zeros(3, device=dev), d_xyz=d["d_xyz"],
                     d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                     cfg=tcfg.raster).image
        render_ms = cuda_ms(lambda: render(
            cam, g, torch.zeros(3, device=dev), d_xyz=d["d_xyz"],
            d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
            cfg=tcfg.raster), reps=5)
    want = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    frame = np.frombuffer(got["frames"][-1], np.uint8).reshape(want.shape)
    cover = float((frame.max(axis=-1) > 0).mean())
    if not np.array_equal(frame, want) or cover <= 0.0:
        raise AssertionError(f"phase 10 viewer: the last frame differs from "
                             f"its direct render (coverage {cover})")
    ms = got["ms"]
    log(f"[phase 10] viewer: {VIEWER_FRAMES} 800x800 frames of phase 6's "
        f"model over loopback, each one K1; round trip per frame (ms) "
        + json.dumps([round(v, 2) for v in ms]) + f"; median "
        f"{np.median(ms[1:]):.2f} ms, the render alone {render_ms:.2f} ms "
        f"({card}); the last frame bitwise its direct render, coverage "
        f"{cover:.3f}")
    return {"launches": counts, "frame_ms": float(np.median(ms[1:])),
            "frame_ms_all": ms, "render_ms": render_ms}


def phase_10(dev, card, res6, tmp: Path) -> dict:
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.ops.cuda.blend import blend_bwd, blend_fwd
    t_start = time.time()
    cfg = RasterConfig()
    # ---- (a) the exchange of SHARD_D ranks, each slab through K1/K2 ----
    gauss, nodes, deform_cfg = full_scene(dev)
    cam = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=0.5,
                       device=dev)
    with torch.no_grad():
        view = shard_view(gauss, nodes, deform_cfg, cam)
        ex = emulate_exchange(view, cam, cfg, SHARD_D)
        if ex["overflow"]:
            raise AssertionError(f"phase 10: overflow {ex['overflow']}")
        fs, b = ex["whole"]
        gx = ex["grid_x"]
        w_count = torch.clamp_max(b.tile_count, cfg.tile_cap)
        w_args = (fs, b.pair_rank, b.tile_start, w_count, gx)
        whole = blend_fwd(*w_args)
        st = stitched_check(ex, cfg, whole)
        slab_res, k1_ms, pairs = [], [], []
        for e, (args, _) in enumerate(ex["slabs"]):
            binning = launch_binning(*args[1:4])
            pairs.append(binning.num_pairs)
            sk, res = check_kernel(f"slab {e} of {SHARD_D}", args[0], binning,
                                   gx, cfg.chunk, tag="phase 10",
                                   gtile=args[6])
            res["pairs"] = binning.num_pairs
            # the slab's bound: its records, pair ranks, starts, counts
            # and map in once, its state rows out once
            res["bound"] = fwd_bound(sk, args[0].numel() * 4 + 4 * (
                args[1].numel() + 3 * args[2].numel()))
            slab_res.append(res)
            k1_ms.append(cuda_ms(lambda: blend_fwd(*args[:6], gtile=args[6]),
                                 reps=10))
        e = int(np.argmax(pairs))           # the busiest slab: K2
        args = ex["slabs"][e][0]
        binning = launch_binning(*args[1:4])
        res_k2 = check_backward(
            f"slab {e} of {SHARD_D}, every tile", args[0], binning, gx,
            cfg.chunk, slab_res[e].pop("flip_mask"), tag="phase 10",
            batch=64, gtile=args[6])
        records, seg = train_buffers(args[3])
        state = blend_fwd(*args[:5], records=records, segments=seg,
                          gtile=args[6])
        g = map_cotangent(state, seed=13)
        k2_ms = cuda_ms(lambda: blend_bwd(*args[:5], state, records, g, seg,
                                          gtile=args[6]), reps=10)
        n_reduce = torch.zeros(1, dtype=torch.int64, device=dev)
        blend_bwd(*args[:5], state, records, g, seg, n_reduce=n_reduce,
                  gtile=args[6])
        k2_slab_bound = k2_bound(args[0], binning, state, records,
                                 int(n_reduce))
        for r in slab_res:
            r.pop("flip_mask", None)
        # (d) K1 and K2 of the whole grid without the map and with the
        # identity map, in this call
        ident = torch.arange(w_count.numel(), dtype=torch.int32, device=dev)
        recs_w, seg_w = train_buffers(w_count)
        st_w = blend_fwd(*w_args, records=recs_w, segments=seg_w)
        g_w = map_cotangent(st_w, seed=14)
        times = {}
        for name, gt_map in (("none", None), ("identity", ident),
                             ("none_again", None)):
            times[name] = (
                cuda_ms(lambda: blend_fwd(*w_args, gtile=gt_map), reps=20),
                cuda_ms(lambda: blend_bwd(*w_args, st_w, recs_w, g_w, seg_w,
                                          gtile=gt_map), reps=20))
    counts, ex_cap = ex["counts"], ex["cap"]
    rec_bytes = (counts * REC_BYTES).tolist()
    balance = float(max(pairs) / np.mean(pairs))
    log(f"[phase 10] exchange of {SHARD_D} ranks at t=0.5 ({card}): records "
        f"per (src, dst) " + json.dumps(counts.tolist()) + f", cap "
        f"{ex['cap']} ({ex['cap'] * REC_BYTES} B per padded block), bytes "
        f"per (src, dst) " + json.dumps(rec_bytes) + f"; pairs per slab "
        + json.dumps(pairs) + f", balance max/mean {balance:.4f}; stitched "
        f"slabs against the whole-grid K1: {st['diff_pixels']} pixels "
        f"differ, {st['depth_tie_pixels']} of them in the "
        f"{st['tie_tiles']} tiles reordered by depth ties")
    log(f"[phase 10] slab K1 ms " + json.dumps([round(v, 4) for v in k1_ms])
        + " (bounds " + json.dumps([round(r["bound"]["bound_ms"], 4)
                                    for r in slab_res])
        + f" ms), K2 on slab {e} {k2_ms:.4f} ms (bound "
        f"{k2_slab_bound['bound_ms']:.4f} ms by "
        f"{k2_slab_bound['bound_by']}); whole grid K1 / K2 ms without "
        f"the map {times['none'][0]:.4f} / {times['none'][1]:.4f}, with the "
        f"identity map {times['identity'][0]:.4f} / "
        f"{times['identity'][1]:.4f}, without again "
        f"{times['none_again'][0]:.4f} / {times['none_again'][1]:.4f} "
        f"({card})")
    del gauss, nodes, view, ex, whole, state, st_w, recs_w, seg_w
    torch.cuda.empty_cache()
    # ---- (b) the sharded training step through NCCL ----
    res_b = sharded_steps(dev, card, cfg, tmp)
    torch.cuda.empty_cache()
    # ---- (c) the viewer ----
    res_c = viewer_frames(dev, card, res6)
    log(f"[phase 10] phase 10 {time.time() - t_start:.1f} s")
    return {"slabs": slab_res, "k1_ms": k1_ms, "k2_ms": k2_ms,
            "k2_bound": k2_slab_bound,
            "k2_check": res_k2, "pairs": pairs, "balance": balance,
            "records": counts.tolist(), "record_bytes": rec_bytes,
            "exchange_cap": ex_cap, "times": times, "stitched": st,
            "launches_sharded": res_b["launches"],
            "launches_viewer": res_c["launches"],
            "sharded": {k: v for k, v in res_b.items() if k != "launches"},
            "viewer": {k: v for k, v in res_c.items() if k != "launches"}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch import native
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.models.gaussians import apply_deform
    from d2dgs_torch.ops.binning import bin_gaussians
    from d2dgs_torch.ops.cuda import build
    from d2dgs_torch.ops.cuda import adam as adam_lib
    from d2dgs_torch.ops.cuda import blend as blend_lib
    from d2dgs_torch.ops.cuda import node_gather as node_gather_lib
    from d2dgs_torch.ops.cuda import raster3d as raster3d_lib
    from d2dgs_torch.ops.cuda.blend import (NREC, SOURCE, SOURCE_BWD,
                                            blend_bwd, blend_fwd,
                                            segment_layout)
    from d2dgs_torch.ops.cuda.adam import adam_step
    from d2dgs_torch.ops.cuda.node_gather import gather_bwd
    from d2dgs_torch.ops.dense_raster import rasterize_dense
    from d2dgs_torch.ops.projection import preprocess, tile_grid
    from d2dgs_torch.ops.tiled_raster import (PIX, blend_tiles_plain,
                                              pack_features, rasterize_tiled)
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import main_stage_step
    from d2dgs_torch.utils.sh import sh_to_rgb

    t_start = time.time()
    dev = torch.device("cuda")
    card = gpu_name_power()
    log(f"[phase 1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.time()
    with ThreadPoolExecutor(6) as pool:      # one compiler per source
        native_lib = pool.submit(native.build)
        built = list(pool.map(build.build, (SOURCE, SOURCE_BWD,
                                            raster3d_lib.SOURCE,
                                            node_gather_lib.SOURCE,
                                            adam_lib.SOURCE)))
        native_lib = native_lib.result()
    for lib, report in built:
        log(f"[phase 1] built {lib.relative_to(ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[phase 1] ptxas: {line.strip()}")
    if not native.available():
        raise AssertionError("the native mesh library did not load")
    log(f"[phase 1] the five CUDA sources and the native mesh library "
        f"({native_lib.relative_to(ROOT)}, g++ from native/mesh_post.cpp) "
        f"built in {time.time() - t0:.1f} s")
    for binding in (blend_lib.LIB_FWD, blend_lib.LIB_BWD, raster3d_lib.LIB,
                    node_gather_lib.LIB, adam_lib.LIB):
        binding.bind()      # declares every entry point, or raises
    log("[phase 1] bound blend_fwd_launch and blend_dense_fwd_launch (K1, "
        "K3), blend_bwd_launch and blend_dense_bwd_launch (K2, K4), "
        "raster3d_fwd_launch and raster3d_bwd_launch (K5, K6), "
        "node_gather_bwd_launch (G2), adam_launch (A1)")
    cfg = RasterConfig()

    # ---- phase 2 and 2b: kernels vs plain on small scenes ----
    H, W = 48, 64
    cam_s = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device=dev)
    bwd_checks, fwd_checks = {}, {}
    for label in SMALL_SCENES:
        arrs = [torch.as_tensor(a, device=dev) for a in small_scene(label)]
        means, scales, quats, opac, colors = arrs
        alive = torch.ones(means.shape[0], dtype=torch.bool, device=dev)
        fs, binning, gx = splat_inputs(means, scales, quats, opac, colors,
                                       alive, cam_s, cfg)
        _, res = check_kernel(label, fs, binning, gx, cfg.chunk)
        bwd_checks[label] = check_backward(label, fs, binning, gx, cfg.chunk,
                                           res.pop("flip_mask"))
        fwd_checks[label] = res
        bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
        ct, at, *_ = rasterize_tiled(means, scales, quats, opac, colors,
                                     cam_s, bg, cfg=cfg)
        cd, ad, *_ = rasterize_dense(means, scales, quats, opac, colors,
                                     cam_s, bg)
        torch.testing.assert_close(ct, cd, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(at, ad, rtol=1e-4, atol=1e-4)
        log(f"[phase 2] {label}: CUDA tiled render matches the dense "
            f"oracle (max |d image| {float((ct - cd).abs().max()):.3g})")

    t0 = time.time()
    gauss, nodes, deform_cfg = full_scene(dev)
    torch.cuda.synchronize()
    log(f"[phase 3] scene: {int(gauss.num_alive)} alive of "
        f"{gauss.capacity}, {int(nodes.num_alive)} nodes, built in "
        f"{time.time() - t0:.1f} s")
    bg = torch.zeros(3, device=dev)
    times = (0.0, 0.25, 0.5, 0.75)
    cams = [orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=t,
                         device=dev) for t in times]

    def warp(cam):
        return deform_gaussians(nodes, deform_cfg, gauss.xyz, cam.time,
                                feature=gauss.feature,
                                motion_mask=gauss.motion_mask)

    def serve(cam):
        """One request: the node warp, then the render."""
        d = warp(cam)
        return render(cam, gauss, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                      cfg=cfg)

    def shade(cam, d):
        """apply_deform and the SH colours, as render() does."""
        means, scales, quats, opac, sh = apply_deform(
            gauss, d["d_xyz"], d["d_rotation"], d["d_scaling"])
        dirs = means - cam.cam_center[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True)
                                 + 1e-20)
        return means, scales, quats, opac, sh_to_rgb(
            gauss.active_sh_degree, sh, dirs)

    def view_inputs(cam):
        return splat_inputs(*shade(cam, warp(cam)), gauss.alive, cam, cfg)

    def stage_ms(cam):
        """CUDA-event time of each stage of one request, run separately."""
        d = warp(cam)
        sh = shade(cam, d)
        means, scales, quats, opac, colors = sh
        gx, gy = tile_grid(cam.H, cam.W)

        def prep_fn():
            prep = preprocess(means, scales, quats, cam)
            return prep._replace(valid=prep.valid & gauss.alive)
        prep = prep_fn()
        op = torch.where(prep.valid, opac, 0.0)
        b = bin_gaussians(prep, gx, gy, cfg, opacity=op)
        feats = lambda: pack_features(prep.T, prep.center, prep.normal,
                                      colors, op)[b.order.long()].contiguous()
        fs = feats()
        return {
            "warp": cuda_ms(lambda: warp(cam), reps=5),
            "shade": cuda_ms(lambda: shade(cam, d), reps=5),
            "preprocess": cuda_ms(prep_fn, reps=5),
            "binning": cuda_ms(lambda: bin_gaussians(prep, gx, gy, cfg,
                                                     opacity=op), reps=5),
            "features": cuda_ms(feats, reps=5),
            "blend_kernel": cuda_ms(lambda: blend_fwd(
                fs, b.pair_rank, b.tile_start, b.tile_count, gx), reps=5)}

    with torch.no_grad():
        inputs = [view_inputs(c) for c in cams]
        fs0, bin0, gx0 = inputs[0]
        state0, res0 = check_kernel("800x800 t=0", fs0, bin0, gx0, cfg.chunk)
        tiles0 = heavy_and_random_tiles(bin0.tile_count, 16, 48, seed=8)
        bwd_checks["800x800 t=0"] = res_k2 = check_backward(
            "800x800 t=0, 16 heaviest + 48 seeded tiles", fs0, bin0, gx0,
            cfg.chunk, res0.pop("flip_mask"), tiles=tiles0)
        fwd_checks["800x800 t=0"] = res0

        # ---- phase 3: the served path, counted ----
        reset_counts()
        outs = []
        for i, cam in enumerate(cams):
            out = serve(cam)
            torch.cuda.synchronize()
            if blend_fwd.launches != i + 1:
                raise AssertionError(f"request {i}: blend kernel launches "
                                     f"{blend_fwd.launches}, expected {i + 1}")
            outs.append(out)
        serve_launches = launch_counts()
        if any(serve_launches[k] for k in ("blend_bwd", "blend_dense_fwd",
                                           "gather_bwd", "adam_step")):
            raise AssertionError(f"serving launched {serve_launches}")
        for t, out in zip(times, outs):
            if out.image.shape != (800, 800, 3) or \
                    out.depth.shape != (800, 800, 1):
                raise AssertionError(f"t={t}: shapes {out.image.shape} "
                                     f"{out.depth.shape}")
            for name in ("image", "depth", "alpha", "rend_normal",
                         "rend_dist", "surf_normal"):
                if not bool(torch.isfinite(getattr(out, name)).all()):
                    raise AssertionError(f"t={t}: non-finite {name}")
            cover = float((out.alpha > 0).float().mean())
            if cover <= 0.0:
                raise AssertionError(f"t={t}: empty render")
            if int(out.overflow) or int(out.clamped):
                raise AssertionError(f"t={t}: overflow/clamped non-zero")
            log(f"[phase 3] t={t}: num_pairs {int(out.num_pairs)}, coverage "
                f"{cover:.4f}, mean rgb {float(out.image.mean()):.4f}")

        # ---- timing (CUDA events, one warm-up each) ----
        kernel_ms, render_ms = [], []
        for t, cam, (fs, binning, gx) in zip(times, cams, inputs):
            args = (fs, binning.pair_rank, binning.tile_start,
                    binning.tile_count, gx)
            kernel_ms.append(cuda_ms(lambda: blend_fwd(*args), reps=20))
            render_ms.append(cuda_ms(lambda: serve(cam), reps=5))
            log(f"[phase 3] t={t}: num_pairs {int(binning.num_pairs)}, max "
                f"tile count {int(binning.tile_count.max())}, kernel "
                f"{kernel_ms[-1]:.4f} ms, render {render_ms[-1]:.3f} ms "
                f"({card})")
        stages = stage_ms(cams[0])
        log(f"[phase 3] t=0 stages (ms, each timed alone): "
            + json.dumps(stages) + f"; sum {sum(stages.values()):.3f} of "
            f"render {render_ms[0]:.3f}")
        args0 = (fs0, bin0.pair_rank, bin0.tile_start, bin0.tile_count, gx0)
        plain_ms = cuda_ms(lambda: blend_tiles_plain(*args0, chunk=cfg.chunk),
                           reps=3)

    # bound of the t=0 launch: bytes in and out once, and the float32
    # operations of the pairs each pixel evaluated and blended
    bound1 = fwd_bound(state0, fs0.numel() * 4 + bin0.pair_rank.numel() * 4
                       + 2 * bin0.tile_start.numel() * 4)
    log(f"[phase 3] t=0 bound: {bound1['n_eval']:.0f} pair-pixel "
        f"evaluations, {bound1['n_blend']:.0f} blends, {bound1['ops']:.4g} "
        f"float32 ops -> {bound1['t_ops']:.4f} ms; {bound1['bytes']} bytes "
        f"-> {bound1['t_bytes']:.4f} ms; plain version {plain_ms:.3f} ms; "
        f"mean render {np.mean(render_ms):.3f} ms")

    # ---- phase 4: the training path at full width, counted ----
    tcfg = TrainConfig(gaussian_capacity=gauss.capacity)
    if tcfg.node_cfg != deform_cfg.node:
        raise AssertionError("the scene's nodes are not TrainConfig's")
    cam_t = cams[2]                                      # t = 0.5
    gt = scene_render(gauss, nodes, deform_cfg, cam_t, cfg)
    scheds = phase4_schedules(tcfg, WARM_STEPS + 10)
    state = training_state(gauss, nodes, seed=5)
    # from zero moments the first step moves every deform weight by its
    # whole LR and raises L1 ~2.7x, which the next nine steps only just
    # undo (tools/phase4_l1.py); the trainer's moments are warm here
    state = warm_moments(state, cam_t, gt, tcfg, scheds[:WARM_STEPS])
    perturb(gauss, seed=6)
    scheds = scheds[WARM_STEPS:]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    l1s, step_ms = [], []
    for i, sched in enumerate(scheds):
        before = (blend_fwd.launches, blend_bwd.launches,
                  gather_bwd.launches, adam_step.launches)
        denom = state.gauss_stats.denom.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = main_stage_step(state, cam_t, gt, tcfg, sched)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        if (blend_fwd.launches, blend_bwd.launches) != (before[0] + 1,
                                                        before[1] + 1):
            raise AssertionError(f"step {i}: launches K1 "
                                 f"{blend_fwd.launches - before[0]}, K2 "
                                 f"{blend_bwd.launches - before[1]}; "
                                 f"expected one each")
        if gather_bwd.launches != before[2] + NODE_GATHERS:
            raise AssertionError(f"step {i}: G2 launches "
                                 f"{gather_bwd.launches - before[2]}, "
                                 f"expected {NODE_GATHERS}")
        if adam_step.launches != before[3] + ADAM_GROUPS:
            raise AssertionError(f"step {i}: A1 launches "
                                 f"{adam_step.launches - before[3]}, "
                                 f"expected {ADAM_GROUPS}")
        check_trained(state, metrics, i)
        seen = state.gauss_stats.denom - denom
        if not bool(((seen == 0) | (seen == 1)).all()) or \
                int(seen.sum()) == 0 or bool(seen[~gauss.alive].any()):
            raise AssertionError(f"step {i}: densify counts rose by "
                                 f"{int(seen.sum())} (0/1 per live "
                                 f"visible Gaussian expected)")
        l1s.append(float(metrics["loss"]))
        log(f"[phase 4] step {i}: L1 {l1s[-1]:.6f}, PSNR "
            f"{float(metrics['psnr']):.3f}, pairs {int(metrics['num_pairs'])}"
            f", visible {int(seen.sum())}, {step_ms[-1]:.3f} ms")
    train_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not l1s[-1] < l1s[0]:
        raise AssertionError(f"L1 did not fall: {l1s}")
    rot = check_card_rotations(state.nodes, tcfg.node_cfg)
    log(f"[phase 4] estimate_rotation on the card vs the float64 oracle on "
        f"{rot['vertices']} vertices of the trained nodes' ARAP graphs: "
        f"worst ratio to the bound (c {rot['c']}) {rot['worst_ratio']:.4f} "
        f"(error {rot['worst_err']:.3e}, bound {rot['worst_bound']:.3e}, "
        f"s2+s3 {rot['worst_s2_plus_s3']:.4e}, s {rot['worst_sigma']}); "
        f"largest error {rot['max_err']:.3e}; {rot['above_floor']} bounds "
        f"above 1e-5, {rot['undetermined']} undetermined")

    # ---- phase 4 timing ----
    train_stages = train_stage_ms(state, cam_t, gt, tcfg, scheds[-1])
    with torch.no_grad():
        fs_t, bin_t, gx_t = view_inputs(cam_t)
        args_t = (fs_t, bin_t.pair_rank, bin_t.tile_start, bin_t.tile_count,
                  gx_t)
        records = torch.empty((bin_t.tile_start.shape[0], NREC, PIX),
                              dtype=torch.int32, device=dev)
        seg_t = segment_layout(bin_t.tile_count)
        train_rep = {}
        state_t = blend_fwd(*args_t, records=records, segments=seg_t,
                            report=train_rep)
        g_t = map_cotangent(state_t, seed=9)
        n_reduce = torch.zeros(1, dtype=torch.int64, device=dev)
        blend_bwd(*args_t, state_t, records, g_t, seg_t, n_reduce=n_reduce)
        item_ns = torch.zeros((seg_t.items.shape[0], 2),
                              dtype=torch.int64, device=dev)
        blend_bwd(*args_t, state_t, records, g_t, seg_t, item_ns=item_ns)
        torch.cuda.synchronize()
        hist_t = walk_histogram(records)
        log(f"[phase 4] t=0.5 view, tiles per walk length: "
            + json.dumps(hist_t))
        k2_items = item_report("phase 4", "K2", item_ns, seg_t.items[:, 0],
                               item_walks(records, seg_t), bin_t.tile_count)
        k1_items = fwd_item_report(
            "phase 4", "K1", lambda **k: blend_fwd(*args_t, **k), state_t,
            bin_t.tile_count)
        k1_items["train_partial_bytes"] = sum(
            train_rep["scratch_bytes"].values())
        k1_train_ms = cuda_ms(lambda: blend_fwd(
            *args_t, records=records, segments=seg_t), reps=20)
        k1_serve_ms = cuda_ms(lambda: blend_fwd(*args_t), reps=20)
        k2_ms = cuda_ms(lambda: blend_bwd(*args_t, state_t, records, g_t,
                                          seg_t), reps=20)
        k2_plain_ms = plain_vjp_all_tiles_ms(fs_t, bin_t, gx_t, g_t,
                                             cfg.chunk)
    train_stages["k2_alone"] = k2_ms
    # the same step's stages on the dense route (K3/K4 and the pair gather)
    tcfg_dense = dataclasses.replace(
        tcfg, raster=dataclasses.replace(cfg, use_workqueue=False))
    train_stages_dense = train_stage_ms(state, cam_t, gt, tcfg_dense,
                                        scheds[-1])
    bound2 = k2_bound(fs_t, bin_t, state_t, records, int(n_reduce))
    bound1_t = fwd_bound(state_t, fs_t.numel() * 4
                         + bin_t.pair_rank.numel() * 4
                         + 2 * bin_t.tile_start.numel() * 4)
    step_mean = float(np.mean(step_ms[1:]))
    log(f"[phase 4] steps 2-10: mean {step_mean:.3f} ms per main-stage "
        f"step at 800x800 ({card}); stages (ms, each timed alone): "
        + json.dumps(train_stages) + f"; peak memory {peak_gb:.2f} GB; the "
        f"same stages on the dense route: " + json.dumps(train_stages_dense))
    log(f"[phase 4] t=0.5 view: pairs {int(bin_t.num_pairs)}; K1 serving "
        f"{k1_serve_ms:.4f} ms, training mode {k1_train_ms:.4f} ms; K2 "
        f"{k2_ms:.4f} ms, plain {k2_plain_ms:.1f} ms (64-tile batches); K2 "
        f"bound: {bound2['n_eval']:.0f} evaluations, {bound2['n_blend']:.0f}"
        f" blends, {bound2['ops']:.4g} ops -> {bound2['t_ops']:.4f} ms; "
        f"{bound2['bytes']} bytes ({bound2['n_reduce']} warp sums) -> "
        f"{bound2['t_bytes']:.4f} ms; K1 bound on this view "
        f"{bound1_t['bound_ms']:.4f} ms by {bound1_t['bound_by']}; "
        f"{k2_items['items']} work items, longest "
        f"{k2_items['slowest_us']:.1f} us; checkpoints "
        f"{seg_t.ckpt.numel() * 4} B (not in the bound)")

    # ---- phase 4b: G2 against its plain version at node-train's shapes ----
    res_g = node_gather_check(dev, card)

    # ---- phase 4c: A1 against its plain version at the cells' shapes ----
    res_a = adam_check(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 5a: K3 and K4 against their plain versions, and timed ----
    res5a = phase_5a(cfg, cam_s, fs_t, bin_t, gx_t, card)
    del fs_t, bin_t, state_t, g_t, records, inputs
    torch.cuda.empty_cache()

    # ---- phase 5b: the Trainer at full width on the dense route ----
    res5b = phase_5b(dev, card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="d2dgs_cli_") as tmp:
        # ---- phase 6: the command line, train -> render -> mesh ----
        res6 = phase_6(dev, card, Path(tmp))
        torch.cuda.empty_cache()

        # ---- phase 9: the other deform types, DQB and cli edit, on the
        # scene before phase 8 adds flow files to it (with them `cli
        # train` adds the flow term once the warm-up ends) ----
        res9 = phase_9(dev, card, res6)
        torch.cuda.empty_cache()

        # ---- phase 7: the geometry path on the articulated figure ----
        res7 = phase_7(dev, card)
        fwd_checks.update(res7["fwd_checks"])
        bwd_checks.update(res7["bwd_checks"])
        torch.cuda.empty_cache()

        # ---- phase 8: the optical-flow training path, through the CLI --
        res8 = phase_8(dev, card, res6)
        torch.cuda.empty_cache()

        # ---- phase 10: the sharded path and the viewer ----
        res10 = phase_10(dev, card, res6, Path(tmp))
    paths = {"serve": serve_launches, "train": train_launches,
             "trainer": res5b["launches"], "cli": res6["launches"],
             "geometry": res7["launches"], "flow": res8["launches"],
             "fields": res9["launches_fields"], "dqb": res9["launches_dqb"],
             "edit": res9["launches_edit"],
             "sharded": res10["launches_sharded"],
             "viewer": res10["launches_viewer"]}
    needed = {"serve": ("blend_fwd",), "train": ("blend_fwd", "blend_bwd"),
              "sharded": ("blend_fwd", "blend_bwd"), "viewer": ("blend_fwd",),
              "trainer": ("blend_dense_fwd", "blend_dense_bwd"),
              "cli": ("blend_fwd", "blend_bwd"),
              "geometry": ("blend_fwd", "blend_bwd"),
              "flow": ("blend_fwd", "blend_bwd", "blend3d_fwd",
                       "blend3d_bwd"),
              "fields": ("blend_fwd", "blend_bwd"), "dqb": ("blend_fwd",),
              "edit": ("blend_fwd",)}
    for path, names in needed.items():
        for k in names:
            if paths[path][k] == 0:
                raise AssertionError(f"{k} was not launched on the {path} "
                                     f"path")
    by_path = lambda k: {path: c[k] for path, c in paths.items()}
    b3, b4 = res5a["k3_bound"], res5a["k4_bound"]
    b5 = res8["blend3d"]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "blend_fwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/blend_fwd.cu",
        "replaces": "d2dgs_tpu/ops/pallas/blend_tpu.py:664",
        "launches": sum(c["blend_fwd"] for c in paths.values()),
        "launches_by_path": by_path("blend_fwd"),
        "max_abs_err": res0["max_abs_err"],
        "flipped_pixels": res0["flipped"], **flip_fields(fwd_checks),
        "geometry_checks": {k: {f: fwd_checks[k][f] for f in (
            "busiest_tile_pairs", "max_abs_err", "flipped")}
            for k in res7["fwd_checks"]},
        "ms": kernel_ms[0],
        "ms_t05": k1_serve_ms, "bound_ms_t05": bound1_t["bound_ms"],
        "ms_training_mode": k1_train_ms,
        "plain_ms": plain_ms, "bound_ms": bound1["bound_ms"],
        "bound_by": bound1["bound_by"], "library_ms": None,
        **fwd_fields(k1_items),
        "render_ms": render_ms, "stages_ms": stages,
        "cli_view_ms": res6["view_ms"],
        "fields_check": {f: res9["fwd_check"][f] for f in (
            "busiest_tile_pairs", "max_abs_err", "flipped", "flips",
            "in_band", "outside_band", "band_max_share", "band_max_ulps",
            "band_max_pairs")},
        "deform_types": {k: res9[k] for k in (
            "hash_step_ms", "hash_live_step_ms", "mlp_step_ms",
            "mlp_live_step_ms", "static_step_ms", "hash_l1",
            "hash_encode", "dqb", "edit", "hash_mesh_faces",
            "hash_test_psnr")},
        "gtile_check": {
            "slabs": [{k: r[k] for k in ("pairs", "max_abs_err", "flipped",
                                         "flips")} | {
                "bound_ms": r["bound"]["bound_ms"],
                "bound_by": r["bound"]["bound_by"]} for r in res10["slabs"]],
            "slab_ms": res10["k1_ms"], "stitched": res10["stitched"],
            "ms_no_map": [res10["times"]["none"][0],
                          res10["times"]["none_again"][0]],
            "ms_identity_map": res10["times"]["identity"][0]},
        "sharded_path": {k: res10[k] for k in (
            "pairs", "balance", "records", "record_bytes", "exchange_cap",
            "sharded", "viewer")}}, {
        "name": "blend_bwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/blend_bwd.cu",
        "replaces": "d2dgs_tpu/ops/pallas/blend_tpu.py:691",
        "launches": sum(c["blend_bwd"] for c in paths.values()),
        "launches_by_path": by_path("blend_bwd"),
        "max_abs_err": res_k2["max_abs_err"],
        "max_norm_err": {k: v["max_norm_err"] for k, v in bwd_checks.items()},
        "flipped_pixels": {k: v["flipped"] for k, v in bwd_checks.items()},
        "geometry_check": res7["bwd_checks"]["geometry step"],
        "fields_check": res9["bwd_check"],
        "gtile_check": dict(res10["k2_check"], ms=res10["k2_ms"],
                            bound_ms=res10["k2_bound"]["bound_ms"],
                            bound_by=res10["k2_bound"]["bound_by"],
                            ms_no_map=[res10["times"]["none"][1],
                                       res10["times"]["none_again"][1]],
                            ms_identity_map=res10["times"]["identity"][1]),
        "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": bound2["bound_ms"], "bound_by": bound2["bound_by"],
        "library_ms": None,
        "work_items": k2_items["items"],
        "longest_item_us": k2_items["slowest_us"],
        "items_span_us": k2_items["span_us"],
        "checkpoint_bytes": seg_t.ckpt.numel() * 4,
        "walk_histogram": hist_t,
        "step_ms": step_ms, "train_stages_ms": train_stages,
        "l1": l1s, "cli_step_ms": res6["train_step_ms"],
        "geometry_step_ms": res7["main_step_ms"],
        "flow_path": {k: res8[k] for k in (
            "flow_step_ms", "flow_step_ms_median", "step_ms_no_flow",
            "step_ms_flow", "peak_gb_no_flow", "peak_gb_flow",
            "raster3d_fwd_ms", "raster3d_fwd_bwd_ms",
            "raster3d_plain_fwd_ms", "raster3d_plain_fwd_bwd_ms",
            "plain_chunks_one_view", "self_term", "crop")}}, {
        "name": "blend_dense_fwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/blend_fwd.cu",
        "replaces": "d2dgs_tpu/ops/pallas/blend_tpu.py:411",
        "launches": res5b["launches"]["blend_dense_fwd"],
        "launches_by_path": by_path("blend_dense_fwd"),
        "max_abs_err": res5a["k3_max_abs_err"],
        "flipped_pixels": {k: v["flipped"]
                           for k, v in res5a["checks"].items()},
        **flip_fields(res5a["checks"]),
        "ms": res5a["k3_ms"], "ms_training_mode": res5a["k3_train_ms"],
        "plain_ms": res5a["k3_plain_ms"], "bound_ms": b3["bound_ms"],
        "bound_by": b3["bound_by"], "library_ms": None,
        **fwd_fields(res5a["k3_items"]),
        "gather_ms": res5a["gather_ms"],
        "gather_bwd_ms": res5a["gather_bwd_ms"],
        "node_step_ms": res5b["node_step_ms"],
        "main_step_ms": res5b["main_step_ms"],
        "node_step_ms_median": res5b["node_step_ms_median"],
        "main_step_ms_median": res5b["main_step_ms_median"],
        "node_stages_ms": res5b["node_stages_ms"],
        "train_stages_ms": train_stages_dense}, {
        "name": "blend_dense_bwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/blend_bwd.cu",
        "replaces": "d2dgs_tpu/ops/pallas/blend_tpu.py:439",
        "launches": res5b["launches"]["blend_dense_bwd"],
        "launches_by_path": by_path("blend_dense_bwd"),
        "max_abs_err": res5a["k4_max_abs_err"],
        "max_norm_err": {k: v["max_norm_err"]
                         for k, v in res5a["grads"].items()},
        "ms": res5a["k4_ms"], "plain_ms": res5a["k4_plain_ms"],
        "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
        "library_ms": None, "work_items": res5a["k4_items"]["items"],
        "longest_item_us": res5a["k4_items"]["slowest_us"],
        "items_span_us": res5a["k4_items"]["span_us"],
        "checkpoint_bytes": res5a["ckpt_bytes"],
        "zero_fill_ms": res5a["k4_zero_fill_ms"]}, {
        "name": "blend3d_fwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/raster3d.cu",
        "replaces": "d2dgs_tpu/ops/raster3d.py:140",
        "launches": sum(c["blend3d_fwd"] for c in paths.values()),
        "launches_by_path": by_path("blend3d_fwd"),
        "max_abs_err": max(b5["fwd_check"]["max_abs_err"].values()),
        "max_abs_err_by_output": b5["fwd_check"]["max_abs_err"],
        "flipped_pixels": b5["fwd_check"]["flipped"],
        "band": {k: b5["fwd_check"][k] for k in (
            "in_band", "outside_band", "band_max_share", "band_max_ulps",
            "band_max_pairs", "single_segment_T_err", "counts_differ")},
        "crop_flipped_pixels": res8["crop"]["flipped"],
        "flow_step_flipped_pixels": res8["k6_own_check"]["k5_flipped"],
        "ms": b5["k5_ms"], "ms_serving": b5["k5_serve_ms"],
        "plain_ms": b5["k5_plain_ms"],
        "bound_ms": b5["k5_bound"]["bound_ms"],
        "bound_by": b5["k5_bound"]["bound_by"], "library_ms": None,
        "pairs": b5["pairs"], "busiest_tile_pairs": b5["busiest_tile_pairs"],
        "multi_segment_tiles": b5["multi_segment_tiles"],
        "work_items": b5["items"], "pass_a_units": b5["units"],
        "grid_items": b5["grid_items"], "grid_units": b5["grid_units"],
        "busiest_item_pairs": b5["busiest_item_pairs"],
        "pass_a_evaluations": b5["pass_a_evaluations"],
        "cull_tests": b5["cull_tests"], "cull_share": b5["cull_share"],
        "pass_a_longest_us": b5["pass_a"]["slowest_us"],
        "pass_b_longest_us": b5["pass_b"]["slowest_us"],
        "pass_a_span_us": b5["pass_a"]["span_us"],
        "pass_b_span_us": b5["pass_b"]["span_us"],
        "scratch_bytes": b5["scratch_bytes"],
        "sync_free": b5["sync_free"],
        "evaluations": b5["k5_bound"]["n_eval"],
        "blends": b5["k5_bound"]["n_blend"],
        "rasterize_3dgs_ms": {
            "kernel": {"fwd": res8["raster3d_fwd_ms"],
                       "fwd_bwd": res8["raster3d_fwd_bwd_ms"]},
            "plain": {"fwd": res8["raster3d_plain_fwd_ms"],
                      "fwd_bwd": res8["raster3d_plain_fwd_bwd_ms"]}},
        "flow_step_ms": res8["flow_step_ms"],
        "step_ms_without_flow_files": res6["train_step_ms"]}, {
        "name": "blend3d_bwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/raster3d.cu",
        "replaces": "d2dgs_tpu/ops/raster3d.py:140",
        "launches": sum(c["blend3d_bwd"] for c in paths.values()),
        "launches_by_path": by_path("blend3d_bwd"),
        "max_abs_err": max(b5["bwd_check"]["max_abs_err"],
                           res8["k6_own_check"]["max_abs_err"]),
        "max_norm_err": {"seeded": b5["bwd_check"]["max_norm_err"],
                         "flow_loss": res8["k6_own_check"]["max_norm_err"]},
        "flipped_pixels": b5["fwd_check"]["flipped"],
        "ms": b5["k6_ms"], "plain_ms": b5["k6_plain_ms"],
        "bound_ms": b5["k6_bound"]["bound_ms"],
        "bound_by": b5["k6_bound"]["bound_by"], "library_ms": None,
        "work_items": b5["items"],
        "busiest_item_pairs": b5["busiest_item_pairs"],
        "cull_share": b5["k6_cull_share"],
        "longest_item_us": b5["k6_items"]["slowest_us"],
        "items_span_us": b5["k6_items"]["span_us"],
        "rewalked": b5["k6_bound"]["n_eval"]}, {
        "name": "gather_bwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/node_gather.cu",
        "replaces": None,
        "launches": sum(c["gather_bwd"] for c in paths.values()),
        "launches_by_path": by_path("gather_bwd"),
        "launches_per_node_step": NODE_GATHERS,
        "tables": [r["table"] for r in res_g["by_width"]],
        "max_rel_err": max(max(r["rel_err_plain"], r["rel_err_float64"])
                           for r in res_g["by_width"]),
        "bitwise_repeat": all(r["bitwise_repeat"]
                              for r in res_g["by_width"]),
        "ms": [r["ms"] for r in res_g["by_width"]],
        "plain_ms": [r["plain_ms"] for r in res_g["by_width"]],
        "bound_ms": [r["bound_ms"] for r in res_g["by_width"]],
        "bound_by": "bytes",
        "library_ms": [r["library_ms"] for r in res_g["by_width"]]}, {
        "name": "adam_step", "route": "cuda",
        "source": "d2dgs_torch/csrc/adam.cu",
        "replaces": None,
        "launches": sum(c["adam_step"] for c in paths.values()),
        "launches_by_path": by_path("adam_step"),
        "launches_per_step": [r["launches_per_step"]
                              for r in res_a["by_field"]],
        "fields": [r["field"] for r in res_a["by_field"]],
        "elements": [r["elements"] for r in res_a["by_field"]],
        "bitwise_plain": all(r["bitwise_plain"] for r in res_a["by_field"]),
        "ms": [r["ms"] for r in res_a["by_field"]],
        "host_ms": [r["host_ms"] for r in res_a["by_field"]],
        "plain_ms": [r["plain_ms"] for r in res_a["by_field"]],
        "plain_host_ms": [r["plain_host_ms"] for r in res_a["by_field"]],
        "bound_ms": [r["bound_ms"] for r in res_a["by_field"]],
        "bound_by": "bytes",
        "library_ms": [r["library_ms"] for r in res_a["by_field"]]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
