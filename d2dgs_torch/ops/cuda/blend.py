"""Wrappers of the blend kernels ``csrc/blend_fwd.cu`` (K1) and
``csrc/blend_bwd.cu`` (K2), and ``BlendTiles``, the autograd function
that pairs them.

K1 replaces ``_fwd_wq_kernel`` of d2dgs_tpu/ops/pallas/blend_tpu.py: it
blends every tile's depth-sorted pair list into the state rows
[T, NSTATE, PIX] (layout ROW_* in ops/tiled_raster.py) in two passes:
each UNIT-pair unit's transmittance products and kept pairs, then one
work item per (tile, SEG-pair segment) walking its kept pairs from the
product of its tile's earlier units, folded per tile; its plain PyTorch
version is ``blend_tiles_plain``, and
``blend_fwd_segments_plain`` emulates its algorithm.  K2 replaces
``_bwd_wq_kernel``: from K1's state, per-pixel records and checkpoints
it computes the gradient of the 18 sorted feature columns, one work item
per (tile, SEG-pair segment); its plain PyTorch version is
``blend_tiles_plain_vjp`` below, and ``blend_bwd_segments_plain``
emulates its algorithm.  The same two libraries also hold K3 and K4, the
dense route's entry points (wrapped in blend_dense.py).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ... import trace
from ...config import (ALPHA_CLIP, ALPHA_CUTOFF, FAR_PLANE,
                       FILTER_INV_SQUARE, NEAR_PLANE, T_CUTOFF)
from .. import blend as B
from ..tiled_raster import (CKPT_ROWS, DEC_MED, DEC_MED_AFTER, DEC_N_MED,
                            DEC_TRIP, NCKPT, NFEAT, NSTATE, PIX, ROW_COLOR,
                            ROW_D1, ROW_D2, ROW_DEPTH, ROW_DISTORTION,
                            ROW_DONE, ROW_MED_D, ROW_MED_W, ROW_N_BLEND,
                            ROW_N_EVAL, ROW_NORMAL, ROW_T, _tile_pixels,
                            blend_tiles_plain, blend_walk)
from . import build

SOURCE = "blend_fwd.cu"
SOURCE_BWD = "blend_bwd.cu"
# K1's per-pixel training records: the positions in the tile's pair list
# of the last blended pair (row REC_LAST) and of the median pair (row 1)
NREC = 2
REC_LAST = 0
# state rows whose cotangent K2 takes as zero, as the TPU kernel does:
# done, the final dist1/dist2 and the two work counters
DEAD_ROWS = (ROW_DONE, ROW_D1, ROW_D2, ROW_N_EVAL, ROW_N_BLEND)
# pairs per work item (segment) of every blend kernel: a training forward
# checkpoints its accumulators (CKPT_ROWS) at every SEG-th pair
SEG = 256
# the forward kernels (csrc/blend_fwd.cu): rows per pixel of a work
# item's partial state, pairs per first-pass unit, and the first pass's
# rows per work item (each unit's transmittance product, then SEG / 32
# words of candidate bits)
NPART = 16
UNIT = 64
NCAND = SEG // UNIT + SEG // 32


class Segments(NamedTuple):
    """A training forward's checkpoints and the work items of the kernels.
    Tile t has max(1, ceil(count[t] / seg)) items, tile by tile: item i
    is segment s = ``items[i, 1]`` (pairs [s*seg, (s+1)*seg)) of tile
    t = ``items[i, 0]``.  The forward (K1/K3) walks each item from the
    transmittance its tile's earlier segments leave and writes, when it
    folds the tile's items in order, checkpoint ``ckpt_off[t] + s``: the
    state after pairs [0, (s+1)*seg), with the T of segment s's own walk.
    The backward (K2/K4) walks item i back from that checkpoint, or from
    the final state for the tile's last segment.  The kernels walk
    SEG-pair segments and take no other ``seg``; the plain emulations
    take any."""
    ckpt_off: torch.Tensor    # [T] int32: tile t's first checkpoint
    items: torch.Tensor       # [I, 2] int32 (tile, segment), I = T + n_bound
    ckpt: torch.Tensor        # [n_bound, NCKPT, PIX] float32
    seg: int = SEG            # pairs per segment

    @property
    def tensors(self) -> tuple:
        """The three tensors, to save for the backward."""
        return self.ckpt_off, self.items, self.ckpt


def segment_layout(counts: torch.Tensor, seg: int = SEG) -> Segments:
    """The checkpoint offsets, the work items and an (unwritten)
    checkpoint buffer for the pair counts ``counts`` [T] (as the blend
    kernels take them, clamped at tile_cap): tile t has
    max(0, ceil(count / seg) - 1) checkpoints.  The buffer is sized from
    the counts, which costs one device-to-host read.  The kernels take
    only the default ``seg`` (SEG)."""
    dev = counts.device
    c = counts.long()
    n_ck = torch.clamp_min((c + seg - 1) // seg - 1, 0)
    ends = torch.cumsum(n_ck, 0)
    n_bound = 0
    if c.numel():
        trace.count("host.reads", 1)
        n_bound = int(ends[-1])
    n_items = c.numel() + n_bound
    off = ends - n_ck
    tiles = torch.arange(c.numel(), device=dev)
    tile = torch.repeat_interleave(tiles, n_ck + 1, output_size=n_items)
    # tile t's items start at item t + off[t]
    items = torch.stack([tile, torch.arange(n_items, device=dev)
                         - (tiles + off)[tile]], dim=1)
    return Segments(off.to(torch.int32), items.to(torch.int32),
                    torch.empty((n_bound, NCKPT, PIX), dtype=torch.float32,
                                device=dev), seg)


def forward_work(num_tiles: int, n_pairs: int,
                 segments: Segments | None = None,
                 max_segs: int | None = None) -> tuple[int, int, int]:
    """(items, slots, units): the forward kernels' grids of work items
    and of first-pass units and the partial slots, as bounds known on the
    host (no read of the counts).  Tile t has max(1, ceil(c / SEG)) <= 1
    + c // SEG items and ceil(c / UNIT) <= 1 + c // UNIT units, so counts
    summing to at most ``n_pairs`` (and at most ``max_segs`` segments
    each) give at most num_tiles + n_pairs // SEG items and num_tiles +
    n_pairs // UNIT units; only tiles of more than one segment keep
    partials, ceil(c / SEG) <= 2 c / SEG each.  A training layout
    (``segments``) gives the items exactly and at most 2 n_bound slots
    (each such tile has at least one checkpoint)."""
    if segments is not None:
        items, slots = segments.items.shape[0], 2 * segments.ckpt.shape[0]
    else:
        items = num_tiles + n_pairs // SEG
        if max_segs is not None:
            items = min(items, num_tiles * max_segs)
        slots = min(items, 2 * n_pairs // SEG)
    units = min(items * (SEG // UNIT), num_tiles + n_pairs // UNIT)
    return items, slots, units


def layout_len(num_tiles: int, n_items: int, n_units: int) -> int:
    """The int32 length of a forward launch's layout buffer
    (csrc/work_layout.cuh ``Layout``): item_start, slot_start, arrivals,
    the unit total, and the item and unit lists."""
    return 3 * num_tiles + 2 + 2 * (n_items + n_units)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    timers = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.blend_fwd_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 9 + timers
    lib.blend_fwd_launch.restype = ctypes.c_int
    lib.blend_dense_fwd_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p] * 9 + timers
    lib.blend_dense_fwd_launch.restype = ctypes.c_int
    lib.blend_fwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = build.load(SOURCE_BWD)
    lib.blend_bwd_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 11
    lib.blend_bwd_launch.restype = ctypes.c_int
    lib.blend_dense_bwd_launch.argtypes = [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
    lib.blend_dense_bwd_launch.restype = ctypes.c_int
    lib.blend_bwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pairs(feats_sorted, pair_rank, tile_start, tile_count, grid_x,
                 gtile=None):
    """Device, type and shape checks shared by both kernels; returns the
    tile count.  Without ``gtile`` the tiles must form whole rows of a
    grid ``grid_x`` tiles wide; with it (int32 [T], each slot's tile in
    that grid) they may be any slab of it."""
    dev = feats_sorted.device
    _check("feats_sorted", feats_sorted, torch.float32, 2, dev)
    _check("pair_rank", pair_rank, torch.int32, 1, dev)
    _check("tile_start", tile_start, torch.int32, 1, dev)
    _check("tile_count", tile_count, torch.int32, 1, dev)
    if feats_sorted.shape[1] != NFEAT:
        raise ValueError(f"feats_sorted must be [N, {NFEAT}], got "
                         f"{tuple(feats_sorted.shape)}")
    num_tiles = tile_start.shape[0]
    if gtile is not None:
        _check("gtile", gtile, torch.int32, 1, dev)
        if gtile.shape[0] != num_tiles:
            raise ValueError(f"gtile {tuple(gtile.shape)} does not give the "
                             f"place of {num_tiles} tiles")
    if tile_count.shape[0] != num_tiles or grid_x <= 0 \
            or (gtile is None and num_tiles % grid_x != 0):
        raise ValueError(f"tile arrays {tuple(tile_start.shape)}/"
                         f"{tuple(tile_count.shape)} do not form a grid "
                         f"{grid_x} tiles wide")
    return num_tiles


def _check_rows(name, t, dtype, rows, num_tiles, device):
    _check(name, t, dtype, 3, device)
    if tuple(t.shape) != (num_tiles, rows, PIX):
        raise ValueError(f"{name} must be [{num_tiles}, {rows}, {PIX}], got "
                         f"{tuple(t.shape)}")


def _check_segments(segments, num_tiles, device):
    """Device, type and shape checks of a ``Segments``; returns the item
    count."""
    if segments is None:
        raise ValueError("segments (segment_layout of the counts) is "
                         "required in training mode")
    if segments.seg != SEG:
        raise ValueError(f"segments are laid out at {segments.seg}-pair "
                         f"segments; the kernels walk {SEG}")
    _check("ckpt_off", segments.ckpt_off, torch.int32, 1, device)
    _check("items", segments.items, torch.int32, 2, device)
    _check("ckpt", segments.ckpt, torch.float32, 3, device)
    n_items = segments.items.shape[0]
    if segments.ckpt_off.shape[0] != num_tiles \
            or segments.items.shape[1] != 2 or tuple(
            segments.ckpt.shape) != (n_items - num_tiles, NCKPT, PIX):
        raise ValueError(f"segments {tuple(segments.ckpt_off.shape)}/"
                         f"{tuple(segments.items.shape)}/"
                         f"{tuple(segments.ckpt.shape)} do not fit "
                         f"{num_tiles} tiles")
    return n_items


def _check_train(records, segments, g_state, state, num_tiles, dev):
    """Checks of the training inputs of a backward kernel; returns the
    item count."""
    _check_rows("state", state, torch.float32, NSTATE, num_tiles, dev)
    _check_rows("records", records, torch.int32, NREC, num_tiles, dev)
    _check_rows("g_state", g_state, torch.float32, NSTATE, num_tiles, dev)
    return _check_segments(segments, num_tiles, dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def blend_fwd(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
              tile_start: torch.Tensor, tile_count: torch.Tensor,
              grid_x: int, chunk: int = 64,
              records: torch.Tensor | None = None,
              segments: Segments | None = None,
              n_pass_a: torch.Tensor | None = None,
              unit_ns: torch.Tensor | None = None,
              item_ns: torch.Tensor | None = None,
              report: dict | None = None,
              gtile: torch.Tensor | None = None) -> torch.Tensor:
    """Blend every tile: feats_sorted [N, NFEAT] float32 (depth order),
    pair_rank [B], tile_start [T], tile_count [T] int32 -> state rows
    [T, NSTATE, PIX] float32.  ``gtile`` (optional int32 [T], the TPU
    kernel's global-tile map) gives output slot t the pixels of tile
    gtile[t] of the grid ``grid_x`` tiles wide (default: slot t is tile t);
    everything else stays per slot.

    Training mode (``records`` [T, NREC, PIX] int32 and ``segments``,
    ``segment_layout(tile_count)``, both given): K1 also writes K2's
    inputs, per pixel the position in its tile's pair list of the last
    blended pair and of the median pair (-1 for none) into ``records``,
    and its accumulators at every SEG-th pair into ``segments.ckpt``.  On
    CPU tensors this is ``blend_tiles_plain`` (which steps ``chunk`` pairs
    at a time) and ``records`` and ``segments`` are left as they are,
    since the plain backward needs neither; on CUDA tensors it launches
    the kernel, or raises: a first pass of one CTA per UNIT pairs of a
    tile (transmittance products and candidate pairs), then one CTA per
    (tile, SEG-pair segment).  Serving sizes the work from B, the pair
    count, and reads nothing back.  ``n_pass_a`` (optional int64 [1] on
    the card) is incremented by the first pass's pair-pixel evaluations,
    the redesign's extra work; ``unit_ns`` [U, 2] and ``item_ns`` [I, 2]
    (optional int64) receive the %globaltimer stamps at the start and end
    of the first pass's units 0..U-1 and of the work items 0..I-1.
    ``report`` (optional dict) receives what the launch allocated and
    launched (``_fwd_launch``); ``forward_layout`` reads its work lists.
    """
    if feats_sorted.device.type == "cpu":
        return blend_tiles_plain(feats_sorted, pair_rank, tile_start,
                                 tile_count, grid_x, chunk=chunk,
                                 tile_ids=gtile)
    dev = feats_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cpu or cuda, not {dev}")
    num_tiles = _check_pairs(feats_sorted, pair_rank, tile_start, tile_count,
                             grid_x, gtile)
    lib = _lib()
    state = _fwd_launch(
        lib.blend_fwd_launch,
        (feats_sorted.data_ptr(), pair_rank.data_ptr(),
         tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, grid_x,
         _ptr(gtile)),
        num_tiles, forward_work(num_tiles, pair_rank.shape[0], segments),
        records, segments, n_pass_a, unit_ns, item_ns, report, dev,
        "blend_fwd")
    blend_fwd.launches += 1
    return state


def _fwd_launch(launcher, head, num_tiles, work, records, segments,
                n_pass_a, unit_ns, item_ns, report, dev, name):
    """Checks of a forward kernel's optional inputs, its output and
    scratch buffers (the work layout, the first pass's products and
    candidate bits, the partial slots), the launch; returns the state
    rows or raises.  ``report`` (optional dict) receives the grids
    (``grid_items``, ``grid_units``), each scratch buffer's bytes
    (``scratch_bytes``) and the layout buffer itself."""
    ckpt = ckpt_off = None
    if records is not None:
        _check_rows("records", records, torch.int32, NREC, num_tiles, dev)
        _check_segments(segments, num_tiles, dev)
        ckpt, ckpt_off = segments.ckpt, segments.ckpt_off
    if n_pass_a is not None:
        _check("n_pass_a", n_pass_a, torch.int64, 1, dev)
    for t, what in ((unit_ns, "unit_ns"), (item_ns, "item_ns")):
        if t is not None:
            _check(what, t, torch.int64, 2, dev)
            if t.shape[1] != 2:
                raise ValueError(f"{what} must be [n, 2], got "
                                 f"{tuple(t.shape)}")
    n_items, n_slots, n_units = work
    state = torch.empty((num_tiles, NSTATE, PIX), dtype=torch.float32,
                        device=dev)
    layout = torch.empty(layout_len(num_tiles, n_items, n_units),
                         dtype=torch.int32, device=dev)
    cand = torch.empty((n_items, NCAND, PIX), dtype=torch.float32,
                       device=dev)
    part = torch.empty((n_slots, NPART, PIX), dtype=torch.float32,
                       device=dev)
    timed = lambda t: 0 if t is None else t.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launcher(*head, n_items, n_units, state.data_ptr(),
                       _ptr(records), _ptr(ckpt), _ptr(ckpt_off),
                       layout.data_ptr(), _ptr(cand), _ptr(part),
                       _ptr(n_pass_a), _ptr(unit_ns), timed(unit_ns),
                       _ptr(item_ns), timed(item_ns), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().blend_fwd_error_string(err).decode())
    if report is not None:
        report.update(
            num_tiles=num_tiles, grid_items=n_items, grid_units=n_units,
            layout=layout,
            scratch_bytes={k: t.numel() * t.element_size() for k, t in (
                ("layout", layout), ("first_pass", cand),
                ("partials", part))})
    return state


def forward_layout(report: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The work a forward launch listed on the card, read back from the
    layout buffer in its ``report`` (after the launch has run): the work
    items [I, 2] (tile, segment) and the first pass's units [U, 2] (tile,
    k: pairs [k UNIT, (k + 1) UNIT)), in launch order (the CTA index)."""
    lay, t = report["layout"], report["num_tiles"]
    n_items, n_units = (int(v) for v in lay[[t, 3 * t + 1]].tolist())
    items = lay[3 * t + 2:].view(-1, 2)
    return items[:n_items], items[report["grid_items"]:][:n_units]


blend_fwd.launches = 0


def blend_tiles_plain_vjp(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
                          tile_start: torch.Tensor, tile_count: torch.Tensor,
                          grid_x: int, g_state: torch.Tensor,
                          tiles: torch.Tensor | None = None,
                          chunk: int = 64,
                          gtile: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K2: the gradient of <state, g_state> in
    feats_sorted [N, NFEAT], by autograd through ``blend_tiles_plain``.

    The cotangents of ``DEAD_ROWS`` are taken as zero, as K2 does.
    ``tiles`` (optional, int64 slot indices) restricts the blend to those
    slots, at their true pixel coordinates, so the plain version can be
    held against K2 on a full-width view without saving every tile's
    chunk intermediates.  ``gtile`` (optional int32 [T]) places slot t at
    tile gtile[t] of the grid, as ``blend_fwd``'s does."""
    g = g_state.clone()
    g[:, list(DEAD_ROWS)] = 0.0
    coords = gtile
    if tiles is not None:
        tile_start, tile_count, g = tile_start[tiles], tile_count[tiles], \
            g[tiles]
        coords = tiles if gtile is None else gtile[tiles]
    with torch.enable_grad():
        f = feats_sorted.detach().requires_grad_()
        state = blend_tiles_plain(f, pair_rank, tile_start, tile_count,
                                  grid_x, chunk=chunk, tile_ids=coords)
        if not state.requires_grad:       # no pairs in these tiles
            return torch.zeros_like(f)
        d_feats, = torch.autograd.grad(state, f, g)
    return d_feats


def pack_checkpoints(ck_tile: torch.Tensor, segments: Segments):
    """The plain forward walk's checkpoints [T, n, NCKPT, PIX] (its k-th
    is the state after pairs [0, (k+1)*seg)) in the kernels' layout
    [n_bound, NCKPT, PIX]: tile t's from row ``ckpt_off[t]``."""
    off = segments.ckpt_off.long()
    n_bound = segments.ckpt.shape[0]
    n_ck = torch.diff(torch.cat([off, off.new_tensor([n_bound])]))
    tile = torch.repeat_interleave(torch.arange(off.numel(),
                                                device=off.device), n_ck)
    return ck_tile[tile, torch.arange(n_bound, device=off.device)
                   - off[tile]]


# kernel-vs-plain tolerances per state row (rtol, atol): colour and alpha
# as the image, the auxiliary rows as the allmap in the JAX package's
# kernel tests (tests/test_pallas_blend.py)
TIGHT = (1e-5, 1e-5)
AUX = (1e-4, 1e-5)


# The threshold band of a flip (compare_states with ``decisions``).  K1/K3
# and the plain walk multiply the same float32 factors (1 - alpha): both
# compute alpha with the same operations in the same order (-fmad=false,
# csrc/blend_fwd.cu), and differ only in how they associate the product
# (K1 unit products and their prefix products, the plain walk a chunk's
# cumulative product scaled by the carried T).  A rounded product of n
# factors, in any association, lies within (1 + u)^n - 1 ~ n u of the
# exact one (u = 2^-24, each multiply rounds to half an ulp), so the two
# walks' T after n blended pairs differ by at most 2 n u T.  A pixel whose
# decision differs has its threshold between the two T, so the plain T
# lies within 2 n u thr of the threshold thr: with 2^e <= thr < 2^(e+1)
# and ulp(thr) = 2^(e-23), that is n (thr / 2^e) ulp(thr) < 2 n ulp(thr).
# A flip is a threshold case when the plain T at its decision lies within
# BAND_ULPS ulps of the threshold per pair blended up to it: 2 (1.64 at
# T_CUTOFF = 1e-4, whose ulp is 2^-37; 1 at 0.5, whose ulp is 2^-24).
BAND_ULPS = 2.0
ULP_CUTOFF = 2.0 ** -37       # the float32 spacing at T_CUTOFF (1e-4)
ULP_HALF = 2.0 ** -24         # the float32 spacing at 0.5 (upward)


def compare_states(sk: torch.Tensor, sp: torch.Tensor,
                   decisions: torch.Tensor | None = None) -> dict:
    """State rows ``sk`` of a blend against a reference's ``sp``.  A pixel
    'flips' when its termination or its median-depth choice differs, in
    one of three kinds, each pixel in the first that fits:
      * ``done``: one side terminated and the other did not (done row);
      * ``median``: the median rows differ (the T > 0.5 choice);
      * ``trip_moved``: both terminated at different pairs because one
        blended the pair the other tripped on (their blended counts differ
        by one and the side that blended it ends with T within 1e-5 of
        T_CUTOFF, relative).
    Every other pixel must agree within the row tolerances (TIGHT, AUX)
    and count the same evaluated and blended pairs (rows 14 and 15); those
    that do not are ``other``.  Returns the per-row max errors outside the
    flips, the flipped and the outside-tolerance pixel counts, the count
    of each kind (``flips``), the flip mask [T, PIX] and each kind's mask
    (``masks``, ``other`` included).

    ``decisions`` [T, NDEC, PIX], the reference walk's threshold-test rows
    (``blend_tiles_plain(decisions=True)``), adds the band test: a median
    or trip_moved flip is a threshold case (``in_band``) when the
    reference's T where the two walks part lies within BAND_ULPS ulps of
    its threshold per pair blended up to there.  For a trip_moved flip
    that T is the reference's T after the pair that one side tripped on
    (its final T where it blended that pair, its ``t_trip`` where it
    tripped on it), against T_CUTOFF, after its blended pairs and one; for
    a median flip the nearer to 0.5 of its T before and after its median
    pair (the later of the two sides' median pairs is the one whose
    pre-blend T decided), after the pairs up to the median.  Adds the
    counts ``in_band`` and ``outside_band`` (median and trip_moved flips
    outside it) and, at the flip that reaches furthest into its band, the
    share of the band reached (``band_max_share``), its distance to the
    threshold in ulps (``band_max_ulps``) and its pairs
    (``band_max_pairs``)."""
    tol = {ROW_T: TIGHT, ROW_D1: AUX, ROW_D2: AUX, ROW_DEPTH: AUX,
           ROW_DISTORTION: AUX, ROW_MED_D: AUX, ROW_MED_W: AUX}
    for sl, t in ((ROW_COLOR, TIGHT), (ROW_NORMAL, AUX)):
        tol.update({r: t for r in range(sl.start, sl.stop)})

    def close(r):
        rtol, atol = tol[r]
        return (sk[:, r] - sp[:, r]).abs() <= atol + rtol * sp[:, r].abs()

    done = sk[:, ROW_DONE] != sp[:, ROW_DONE]
    median = ~done & ~(close(ROW_MED_D) & close(ROW_MED_W))
    extra = sk[:, ROW_N_BLEND] - sp[:, ROW_N_BLEND]
    t_more = torch.where(extra > 0, sk[:, ROW_T], sp[:, ROW_T])
    trip_moved = ~done & ~median & (sk[:, ROW_DONE] == 1.0) \
        & (sp[:, ROW_DONE] == 1.0) & (extra.abs() == 1.0) \
        & ((t_more - T_CUTOFF).abs() <= 1e-5 * T_CUTOFF)
    flip = done | median | trip_moved
    keep = ~flip
    row_err = {r: float((sk[:, r] - sp[:, r]).abs()[keep].max())
               if bool(keep.any()) else 0.0 for r in sorted(tol)}
    bad = torch.zeros_like(flip)
    for r in tol:
        bad |= ~close(r)
    for r in (ROW_N_EVAL, ROW_N_BLEND):
        bad |= sk[:, r] != sp[:, r]
    bad &= keep
    masks = {"done": done, "median": median, "trip_moved": trip_moved,
             "other": bad}
    res = {"row_max_abs_err": row_err, "flipped": int(flip.sum()),
           "pixels": flip.numel(), "bad_outside_flips": int(bad.sum()),
           "flips": {k: int(masks[k].sum())
                     for k in ("done", "median", "trip_moved")},
           "max_abs_err": max(row_err.values()), "flip_mask": flip,
           "masks": masks}
    if decisions is not None:
        res.update(threshold_band(sp, decisions, median, trip_moved, extra))
    return res


def threshold_band(sp: torch.Tensor, decisions: torch.Tensor,
                   median: torch.Tensor, trip_moved: torch.Tensor,
                   extra: torch.Tensor) -> dict:
    """The band test of ``compare_states`` on its median and trip_moved
    masks, ``extra`` the kernel's blended pairs minus the reference's."""
    d64 = decisions.to(torch.float64)
    t_trip = torch.where(extra > 0, d64[:, DEC_TRIP],
                         sp[:, ROW_T].to(torch.float64))
    ulps_trip = (t_trip - T_CUTOFF).abs() / ULP_CUTOFF
    ulps_med = torch.minimum((d64[:, DEC_MED] - 0.5).abs(),
                             (d64[:, DEC_MED_AFTER] - 0.5).abs()) / ULP_HALF
    ulps = torch.where(trip_moved, ulps_trip, ulps_med)
    pairs = torch.where(trip_moved, sp[:, ROW_N_BLEND].to(torch.float64)
                        + 1.0, d64[:, DEC_N_MED])
    share = ulps / (BAND_ULPS * torch.clamp_min(pairs, 1.0))
    judged = median | trip_moved
    in_band = judged & (share <= 1.0)        # NaN (no decision) is out
    worst = torch.where(judged, torch.nan_to_num(share, nan=float("inf")),
                        -1.0).flatten()
    at = int(torch.argmax(worst)) if bool(judged.any()) else None
    pick = lambda x: 0.0 if at is None else float(x.flatten()[at])
    return {"in_band": int(in_band.sum()),
            "outside_band": int((judged & ~in_band).sum()),
            "band_max_share": pick(worst), "band_max_ulps": pick(ulps),
            "band_max_pairs": pick(pairs)}


def blend_fwd_segments_plain(rows: torch.Tensor, counts: torch.Tensor,
                             grid_x: int, seg: int = SEG, chunk: int = 64,
                             train: bool = False,
                             t_in: torch.Tensor | None = None):
    """Plain emulation of K1/K3's algorithm at segment length ``seg``: the
    state rows [T, NSTATE, PIX] of the blend of a tile's pair rows, rows
    [T, L, NFEAT] (row i of tile t its i-th pair; only rows < counts[t]
    are blended).  With ``train`` it returns ``(state, ckpt, records)``
    as ``blend_walk(checkpoints=seg)`` does.

    Pass A takes each segment's product of (1 - alpha) over its kept
    pairs; pass B walks every segment of every tile at once from T_in,
    the ordered product of its tile's earlier products (dist1/dist2 from
    zero, T absolute); a pixel that enters below T_CUTOFF walks nothing.
    The fold then adds each tile's segments in order, stopping at the
    first that reports done.  A pixel that enters a segment below the
    cutoff without an earlier trip (rounding) trips at the segment's
    first kept pair.  ``t_in`` [T, S, PIX] (S the most segments of a
    tile) replaces pass A's incoming T, to test the fold's decisions.  For
    the CPU tests of the algorithm; the kernels' wrappers take SEG
    only."""
    num_tiles, cap, _ = rows.shape
    dev = rows.device
    c = counts.long()
    n_own = torch.clamp_min((c + seg - 1) // seg, 1)         # [T]
    n_seg = int(n_own.max()) if num_tiles else 1
    step = math.gcd(chunk, seg)
    lane = torch.arange(step, device=dev)
    s_idx = torch.arange(n_seg, device=dev)
    nb = torch.clamp(c[:, None] - s_idx * seg, 0, seg)        # [T, S]
    pix = _tile_pixels(grid_x, torch.arange(num_tiles, device=dev))
    pix = pix[:, None].expand(num_tiles, n_seg, PIX, 2)

    def responses(j0):
        """Features [T, S, step, NFEAT], alpha and depth [T, S, step, P] of
        pairs j0 .. j0 + step - 1 of every segment."""
        g = rows[:, torch.clamp_max(s_idx[:, None] * seg + j0 + lane,
                                    cap - 1)]
        opac = torch.where(j0 + lane < nb[..., None], g[..., 17], 0.0)
        alpha, depth = B.pixel_responses(
            g[..., 0:9].reshape(*g.shape[:3], 3, 3), g[..., 9:11], opac,
            pix)
        return g, alpha, depth

    # pass A, and each segment's first kept pair (for the rare re-walk)
    prod = torch.ones((num_tiles, n_seg, PIX), device=dev)
    first = torch.full((num_tiles, n_seg, PIX), seg, device=dev)
    for j0 in range(0, seg, step):
        _, alpha, _ = responses(j0)
        prod = prod * torch.prod(1.0 - alpha, dim=-2)
        first = torch.minimum(first, torch.where(
            alpha > 0.0, (j0 + lane)[:, None], seg).amin(dim=-2))
    if t_in is None:
        t_in = torch.cat([torch.ones_like(prod[:, :1]),
                          torch.cumprod(prod, dim=1)[:, :-1]], dim=1)
    pre = t_in < T_CUTOFF
    # pass B
    st = B.init_state((num_tiles, n_seg, PIX), device=dev,
                      positions=True)._replace(T=t_in, done=pre)
    for j0 in range(0, seg, step):
        g, alpha, depth = responses(j0)
        st = B.blend_chunk(st, alpha, depth, g[..., 14:17], g[..., 11:14],
                           n_rows=torch.clamp(nb - j0, 0, step), offset=j0)
    part = torch.stack(
        [st.T, st.done.float(), st.dist1, st.dist2, *st.color.unbind(-1),
         st.depth, *st.normal.unbind(-1), st.distortion, st.med_depth,
         st.med_weight, st.n_eval, st.n_blend], dim=2)        # [T,S,16,P]
    sum_w = t_in - st.T
    trip = first < nb[..., None]
    # the fold, segment by segment
    out = torch.zeros((num_tiles, NSTATE, PIX), device=dev)
    out[:, ROW_T] = 1.0
    last = torch.full((num_tiles, PIX), -1, dtype=torch.int64, device=dev)
    med = last.clone()
    ckpt = []
    sums = [ROW_D1, ROW_D2, *range(ROW_COLOR.start, ROW_COLOR.stop),
            ROW_DEPTH, *range(ROW_NORMAL.start, ROW_NORMAL.stop),
            ROW_N_EVAL, ROW_N_BLEND]
    for s in range(n_seg):
        if train and s:
            ckpt.append(out[:, list(CKPT_ROWS)].clone())
        p = part[:, s]
        live = (out[:, ROW_DONE] == 0.0) & (s < n_own)[:, None]
        walked = live & ~pre[:, s]
        new = out.clone()
        new[:, ROW_DISTORTION] = out[:, ROW_DISTORTION] + (
            p[:, ROW_DISTORTION] + out[:, ROW_D2] * sum_w[:, s]
            - 2.0 * out[:, ROW_D1] * p[:, ROW_D1])
        new[:, sums] = out[:, sums] + p[:, sums]
        new[:, ROW_T] = torch.where(pre[:, s], out[:, ROW_T], p[:, ROW_T])
        new[:, ROW_DONE] = p[:, ROW_DONE]
        has_med = st.med[:, s] >= 0
        for r in (ROW_MED_D, ROW_MED_W):
            new[:, r] = torch.where(has_med, p[:, r], out[:, r])
        rewalk = live & pre[:, s]
        new[:, ROW_N_EVAL] = torch.where(
            rewalk, out[:, ROW_N_EVAL] + torch.where(
                trip[:, s], first[:, s] + 1, nb[:, s, None]),
            new[:, ROW_N_EVAL])
        new[:, ROW_DONE] = torch.where(rewalk, trip[:, s].float(),
                                       new[:, ROW_DONE])
        out = torch.where((walked | rewalk)[:, None], new, out)
        med = torch.where(walked & has_med, s * seg + st.med[:, s], med)
        last = torch.where(walked & (st.last[:, s] >= 0),
                           s * seg + st.last[:, s], last)
    if not train:
        return out
    ckpt = torch.stack(ckpt, dim=1) if ckpt else \
        out.new_zeros((num_tiles, 0, NCKPT, PIX))
    return out, ckpt, torch.stack([last, med], dim=1).to(torch.int32)


def suffix_sums(post: torch.Tensor, final: torch.Tensor,
                g_state: torch.Tensor, med_w: torch.Tensor,
                med_after: torch.Tensor):
    """The running sums of the backward walk at a boundary e, in closed
    form: ``post`` and ``final`` [..., NCKPT, P] are the checkpoint rows
    (CKPT_ROWS) after pairs [0, e) and after all pairs, ``g_state``
    [..., NSTATE, P] the cotangent, ``med_w`` [..., P] the final median
    weight and ``med_after`` [..., P] whether the median pair is at or
    past e.  Returns (sum_w, sum_wm, Q): the sums of w and w*m over the
    blended pairs from e on and their transmittance adjoint with the
    T-output term (csrc/blend_bwd.cu)."""
    t_f, d1_f, d2_f = final[..., 0, :], final[..., 1, :], final[..., 2, :]
    sum_w = post[..., 0, :] - t_f
    sum_wm = d1_f - post[..., 1, :]
    diff = final - post
    # colour, depth and normal: checkpoint rows 3-9 are state rows 4-10
    q = g_state[..., 0, :] * t_f + torch.sum(
        g_state[..., 4:11, :] * diff[..., 3:10, :], dim=-2)
    q = q + g_state[..., 11, :] * (diff[..., 10, :] - sum_wm * sum_wm
                                   - t_f * (d2_f - post[..., 2, :]))
    q = q + torch.where(med_after, g_state[..., ROW_MED_W, :] * med_w, 0.0)
    return sum_w, sum_wm, q


def blend_bwd_segments_plain(rows: torch.Tensor, counts: torch.Tensor,
                             grid_x: int, g_state: torch.Tensor,
                             seg: int = SEG, chunk: int = 64,
                             forward: tuple | None = None) -> torch.Tensor:
    """Plain emulation of K2/K4's algorithm at segment length ``seg``:
    the gradient of <state, g_state> in a tile's pair rows, rows [T, L,
    NFEAT] (row i of tile t its i-th pair; only rows < counts[t] are
    blended) -> [T, L, NFEAT].

    The plain forward walk writes the checkpoints at every ``seg``-th
    pair and the per-pixel records; ``segment_layout`` packs them and
    lists the work items; each item takes its post-state from its
    checkpoint (or the final state), its running sums from
    ``suffix_sums`` and walks its segment back to front with the
    kernel's arithmetic, all items at once.  The cotangents of
    ``DEAD_ROWS`` are not read.  ``forward`` takes the forward's
    ``(state, ckpt, records)`` from elsewhere (``blend_fwd_segments_plain``
    with ``train``) in place of the plain walk's.  For the CPU tests of
    the algorithm."""
    num_tiles, cap, _ = rows.shape
    dev = rows.device
    step = math.gcd(chunk, seg)
    lane = torch.arange(step, device=dev)
    tiles = torch.arange(num_tiles, device=dev)
    state, ck_tile, records = forward if forward is not None else blend_walk(
        lambda c0: rows[:, torch.clamp_max(c0 + lane, cap - 1)], counts,
        grid_x, step, tiles, checkpoints=seg)
    lay = segment_layout(counts, seg)
    off = lay.ckpt_off.long()
    n_bound = lay.ckpt.shape[0]
    ckpt = pack_checkpoints(ck_tile, lay)

    t, s = lay.items.long().unbind(1)
    last = records[t, 0].long()
    med = records[t, 1].long()
    n_walk = (records[:, 0].amax(dim=1).long() + 1)[t]
    s0 = s * seg
    s1 = torch.minimum(s0 + seg, n_walk)
    final = state[t][:, list(CKPT_ROWS)]
    g = g_state[t]
    has_ck = (s1 < n_walk)[:, None, None]
    post = final if n_bound == 0 else torch.where(
        has_ck, ckpt[torch.clamp(off[t] + s, 0, n_bound - 1)], final)
    sum_w, sum_wm, Q = suffix_sums(post, final, g, state[t, ROW_MED_W],
                                   med >= s1[:, None])
    T, D1, D2 = post[:, 0], post[:, 1], post[:, 2]
    gT, g_dist = g[:, 0], g[:, 11]
    gc, g_depth, gn = g[:, 4:7], g[:, 7], g[:, 8:11]
    g_med_d, g_med_w = g[:, 12], g[:, 13]
    pix = _tile_pixels(grid_x, t)
    px, py = pix[..., 0], pix[..., 1]
    d_rows = torch.zeros_like(rows)
    for j in range(seg - 1, -1, -1):
        p = s0 + j
        f = rows[t, torch.clamp(p, 0, cap - 1)][:, :, None]      # [I,18,1]
        walk = (p < s1)[:, None] & (p[:, None] <= last)
        # ray-splat intersection, as csrc/blend_bwd.cu
        kx, ky, kz = px * f[:, 6] - f[:, 0], px * f[:, 7] - f[:, 1], \
            px * f[:, 8] - f[:, 2]
        lx, ly, lz = py * f[:, 6] - f[:, 3], py * f[:, 7] - f[:, 4], \
            py * f[:, 8] - f[:, 5]
        p_x = ky * lz - kz * ly
        p_y = kz * lx - kx * lz
        p_z = kx * ly - ky * lx
        good = p_z != 0.0
        inv_pz = 1.0 / torch.where(good, p_z, 1.0)
        sx, sy = p_x * inv_pz, p_y * inv_pz
        rho3d = sx * sx + sy * sy
        dx, dy = f[:, 9] - px, f[:, 10] - py
        rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
        use3d = rho3d <= rho2d
        depth = torch.where(use3d, sx * f[:, 6] + sy * f[:, 7] + f[:, 8],
                            f[:, 8])
        E = torch.exp(-0.5 * torch.minimum(rho3d, rho2d))
        raw = f[:, 17] * E
        alpha = torch.clamp_max(raw, ALPHA_CLIP)
        blended = walk & good & (depth >= NEAR_PLANE) & (alpha >= ALPHA_CUTOFF)
        # pre-blend state and the cotangents, as csrc/blend_bwd.cu
        om = 1.0 - torch.where(blended, alpha, 0.0)
        Tb = T / om
        w = alpha * Tb
        safe_d = torch.where(depth != 0.0, depth, 1.0)
        m = (FAR_PLANE * depth - FAR_PLANE * NEAR_PLANE) / (
            (FAR_PLANE - NEAR_PLANE) * safe_d)
        wm = w * m
        D1b = D1 - wm
        D2b = D2 - wm * m
        err = m * m * (1.0 - Tb) + D2b - 2.0 * m * D1b
        is_med = med == p[:, None]
        S1 = -2.0 * g_dist * sum_wm
        S2 = g_dist * sum_w
        wbar = (gc[:, 0] * f[:, 14] + gc[:, 1] * f[:, 15] + gc[:, 2] * f[:, 16]
                + gn[:, 0] * f[:, 11] + gn[:, 1] * f[:, 12]
                + gn[:, 2] * f[:, 13] + g_depth * depth + g_dist * err
                + m * S1 + m * m * S2 + torch.where(is_med, g_med_w, 0.0))
        mbar = w * S1 + 2.0 * wm * S2 \
            + g_dist * w * (2.0 * m * (1.0 - Tb) - 2.0 * D1b)
        dm_dd = FAR_PLANE * NEAR_PLANE / ((FAR_PLANE - NEAR_PLANE)
                                          * safe_d * safe_d)
        dbar = g_depth * w + mbar * dm_dd + torch.where(is_med, g_med_d, 0.0)
        abar = wbar * Tb - Q / om
        raw_bar = torch.where(raw < ALPHA_CLIP, abar, 0.0)
        rho_bar = -0.5 * raw_bar * raw
        r3b = torch.where(use3d, rho_bar, 0.0)
        r2b = rho_bar - r3b
        dbm = torch.where(use3d, dbar, 0.0)
        sx_bar = dbm * f[:, 6] + 2.0 * r3b * sx
        sy_bar = dbm * f[:, 7] + 2.0 * r3b * sy
        pxb, pyb = sx_bar * inv_pz, sy_bar * inv_pz
        pzb = -(sx_bar * sx + sy_bar * sy) * inv_pz
        kx_b, ky_b, kz_b = pzb * ly - pyb * lz, pxb * lz - pzb * lx, \
            pyb * lx - pxb * ly
        lx_b, ly_b, lz_b = pyb * kz - pzb * ky, pzb * kx - pxb * kz, \
            pxb * ky - pyb * kx
        grads = torch.stack([
            -kx_b, -ky_b, -kz_b, -lx_b, -ly_b, -lz_b,
            kx_b * px + lx_b * py + dbm * sx,
            ky_b * px + ly_b * py + dbm * sy,
            kz_b * px + lz_b * py + dbar,
            2.0 * FILTER_INV_SQUARE * r2b * dx,
            2.0 * FILTER_INV_SQUARE * r2b * dy,
            w * gn[:, 0], w * gn[:, 1], w * gn[:, 2],
            w * gc[:, 0], w * gc[:, 1], w * gc[:, 2], raw_bar * E], dim=-1)
        grads = torch.where(blended[..., None], grads, 0.0).sum(dim=1)
        in_seg = p < s1
        d_rows.index_put_((t[in_seg], p[in_seg]), grads[in_seg],
                          accumulate=True)
        Q = torch.where(blended, Q + wbar * w - g_dist * wm * m * Tb, Q)
        sum_w = torch.where(blended, sum_w + w, sum_w)
        sum_wm = torch.where(blended, sum_wm + wm, sum_wm)
        T = torch.where(blended, Tb, T)
        D1 = torch.where(blended, D1b, D1)
        D2 = torch.where(blended, D2b, D2)
    return d_rows


def blend_bwd(feats_sorted: torch.Tensor, pair_rank: torch.Tensor,
              tile_start: torch.Tensor, tile_count: torch.Tensor,
              grid_x: int, state: torch.Tensor, records: torch.Tensor,
              g_state: torch.Tensor, segments: Segments | None = None,
              chunk: int = 64, n_reduce: torch.Tensor | None = None,
              item_ns: torch.Tensor | None = None,
              gtile: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the blend in feats_sorted: K1's inputs (``gtile`` as
    ``blend_fwd`` took it), its ``state``, ``records`` and ``segments``
    (training mode), and the cotangent ``g_state`` [T, NSTATE, PIX] ->
    d_feats_sorted [N, NFEAT] float32.

    On CPU tensors this is ``blend_tiles_plain_vjp`` (``state``,
    ``records`` and ``segments`` unused); on CUDA tensors it launches the
    kernel, one CTA per work item of ``segments``, or raises.
    ``n_reduce`` (optional int64 [1] on the card) is incremented by the
    number of (warp, pair) sums the kernel issued, 18 atomics each;
    ``item_ns`` (optional int64 [I, 2]) receives each work item's
    %globaltimer stamps at its start and end.
    """
    if feats_sorted.device.type == "cpu":
        return blend_tiles_plain_vjp(feats_sorted, pair_rank, tile_start,
                                     tile_count, grid_x, g_state, chunk=chunk,
                                     gtile=gtile)
    dev = feats_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"blend_bwd runs on cpu or cuda, not {dev}")
    num_tiles = _check_pairs(feats_sorted, pair_rank, tile_start, tile_count,
                             grid_x, gtile)
    n_items = _check_train(records, segments, g_state, state, num_tiles, dev)
    if n_reduce is not None:
        _check("n_reduce", n_reduce, torch.int64, 1, dev)
    if item_ns is not None:
        _check("item_ns", item_ns, torch.int64, 2, dev)
        if tuple(item_ns.shape) != (n_items, 2):
            raise ValueError(f"item_ns must be [{n_items}, 2]")
    d_feats = torch.zeros_like(feats_sorted)
    lib = _lib_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_bwd_launch(
            feats_sorted.data_ptr(), pair_rank.data_ptr(),
            tile_start.data_ptr(), n_items, grid_x, _ptr(gtile),
            segments.items.data_ptr(), segments.ckpt_off.data_ptr(),
            segments.ckpt.data_ptr(), state.data_ptr(), records.data_ptr(),
            g_state.data_ptr(), d_feats.data_ptr(), _ptr(n_reduce),
            _ptr(item_ns), stream)
    if err != 0:
        raise RuntimeError("blend_bwd kernel launch failed: "
                           + lib.blend_bwd_error_string(err).decode())
    blend_bwd.launches += 1
    return d_feats


blend_bwd.launches = 0


class BlendTiles(torch.autograd.Function):
    """State rows of the blend, differentiable in feats_sorted: forward
    K1 in training mode, backward K2.  The gather ``feats[order]`` stays
    outside, so autograd sums the per-rank gradients per Gaussian."""

    @staticmethod
    def forward(ctx, feats_sorted, pair_rank, tile_start, tile_count,
                grid_x, chunk=64, gtile=None):
        records = torch.empty((tile_start.shape[0], NREC, PIX),
                              dtype=torch.int32, device=feats_sorted.device)
        segments = segment_layout(tile_count)
        state = blend_fwd(feats_sorted, pair_rank, tile_start, tile_count,
                          grid_x, chunk=chunk, records=records,
                          segments=segments, gtile=gtile)
        ctx.save_for_backward(feats_sorted, pair_rank, tile_start,
                              tile_count, state, records, *segments.tensors)
        ctx.grid_x, ctx.chunk, ctx.gtile = grid_x, chunk, gtile
        return state

    @staticmethod
    def backward(ctx, g_state):
        feats_sorted, pair_rank, tile_start, tile_count, state, records, \
            *segments = ctx.saved_tensors
        d_feats = blend_bwd(feats_sorted, pair_rank, tile_start, tile_count,
                            ctx.grid_x, state, records,
                            g_state.contiguous(), Segments(*segments),
                            chunk=ctx.chunk, gtile=ctx.gtile)
        return d_feats, None, None, None, None, None, None
