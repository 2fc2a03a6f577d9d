"""The segment-parallel blend forward (K1/K3, csrc/blend_fwd.cu) as an
algorithm, on the CPU: ``blend_fwd_segments_plain`` (the plain emulation
of the kernels' transmittance products, segment walks and in-order fold)
against the plain blend on both routes' rows and against the JAX
package's K1 and K3 (in interpret mode), on hand-made pair lists that put
a termination, a median or a rounding case at a segment boundary, and in
training mode against the plain walk's checkpoints and records, feeding
the segment-parallel backward.

Tolerances: the state rows as ``compare_states`` judges them (colour and
T rtol/atol 1e-5, the other rows rtol 1e-4 atol 1e-5, the work counters
exact, no flipped pixel at 48x64); against JAX, those the JAX package
holds its own kernels to (tests/test_pallas_blend.py); gradients
max-normalised rtol 2e-4 atol 2e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.pallas.blend_tpu import (blend_tiles_pallas,
                                            blend_tiles_wq,
                                            build_work_queue)
from d2dgs_tpu.ops.pallas.blend_tpu import build_gdata as jbuild_gdata
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_torch.config import T_CUTOFF, RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import (DEAD_ROWS, SEG,
                                        blend_bwd_segments_plain,
                                        blend_fwd_segments_plain,
                                        blend_tiles_plain_vjp,
                                        compare_states)
from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_plain,
                                              blend_dense_plain_vjp,
                                              build_gdata)
from d2dgs_torch.ops.projection import preprocess
from d2dgs_torch.ops.tiled_raster import (NFEAT, NSTATE, PIX, ROW_DONE,
                                          ROW_MED_D, ROW_N_BLEND, ROW_N_EVAL,
                                          ROW_T, blend_tiles_plain,
                                          blend_walk, pack_features)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

H, W = 48, 64
IMG = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
IMG_ROWS = [0, 1, 4, 5, 6]                  # T, done, colour
AUX_ROWS = [2, 3, 7, 8, 9, 10, 11, 12, 13]


def T(a):
    return torch.from_numpy(np.array(a))


def _tile_rows(feats_sorted, binning):
    """Each tile's pair rows [T, L, NFEAT] (zero past its count) and the
    sorted-feature row of each, -1 past the count: the work-queue route's
    rows in the dense layout."""
    count = binning.tile_count.long()
    lane = torch.arange(int(count.max()))
    valid = lane[None, :] < count[:, None]
    src = torch.clamp(binning.tile_start.long()[:, None] + lane[None, :], 0,
                      binning.pair_rank.shape[0] - 1)
    index = torch.where(valid, binning.pair_rank.long()[src], -1)
    rows = torch.where(valid[..., None], feats_sorted[index.clamp_min(0)],
                       0.0)
    return rows, index


class View:
    """One check scene's blend inputs on both routes and its plain state."""

    def __init__(self, kind):
        means, scales, quats, opac, colors = map(T, blend_test_scene(kind))
        cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device="cpu")
        self.gx, gy = tile_grid(H, W)
        prep = preprocess(means, scales, quats, cam)
        op = torch.where(prep.valid, opac, 0.0)
        self.binning = bin_gaussians(prep, self.gx, gy, RasterConfig(),
                                     opacity=op)
        feats = pack_features(prep.T, prep.center, prep.normal, colors, op)
        self.fs = feats[self.binning.order.long()].contiguous()
        self.gdata, self.counts = build_gdata(
            feats, self.binning, int(self.binning.tile_count.max()))
        b = self.binning
        self.args = (b.pair_rank, b.tile_start, b.tile_count, self.gx)
        self.plain = blend_tiles_plain(self.fs, *self.args)


@pytest.fixture(scope="module")
def views():
    return {kind: View(kind) for kind in ("pallas", "opaque", "packed")}


def _judge(out, ref, what):
    """compare_states' judgement: no flipped pixel, none outside the row
    tolerances, the work counters exact."""
    res = compare_states(out, ref)
    assert res["flipped"] == 0 and res["bad_outside_flips"] == 0, (
        what, {k: v for k, v in res.items()
               if k not in ("flip_mask", "masks")})


@pytest.mark.parametrize("seg", [8, 64, 256])
@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_segments_fwd_plain_matches_plain(views, kind, seg):
    """The emulation equals the plain blend on the dense route's slabs
    and on the work-queue route's rows, at segments of 8 pairs up to the
    kernels' 256; the packed scene's busiest tile spans three 256-pair
    segments and the opaque scene terminates every pixel early."""
    v = views[kind]
    if kind == "packed":
        assert int(v.counts.max()) > 2 * SEG
    if kind == "opaque":
        assert float(v.plain[:, ROW_DONE].sum()) > 0
    ref_dense = blend_dense_plain(v.gdata, v.counts, v.gx)
    _judge(blend_fwd_segments_plain(v.gdata, v.counts, v.gx, seg=seg),
           ref_dense, f"dense {kind} seg {seg}")
    rows, _ = _tile_rows(v.fs, v.binning)
    _judge(blend_fwd_segments_plain(rows, v.binning.tile_count, v.gx,
                                    seg=seg), v.plain,
           f"work queue {kind} seg {seg}")


@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_segments_fwd_plain_matches_jax_k1_k3(kind):
    """The emulation at 64-pair segments against the JAX package's K1
    (``_fwd_wq_kernel`` through ``blend_tiles_wq``) and K3 (``_fwd_kernel``
    through ``blend_tiles_pallas``), both in interpret mode as
    tests/test_torch_raster.py and tests/test_torch_dense_blend.py run
    them, on the same features and pairs: state rows 0-13."""
    means, scales, quats, opac, colors = blend_test_scene(kind)
    cam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)
    gx, gy = tile_grid(H, W)
    cap, pair_cap = (768, 8192) if kind == "packed" else (256, 2048)
    jcfg = JRasterConfig(tile_cap=cap, chunk=64, pair_cap=pair_cap,
                         emission_cap=1 << 14)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), cam)
    op = jnp.where(prep.valid, jnp.asarray(opac), 0.0)
    jb = jbin(prep, gx, gy, jcfg, opacity=op)
    assert int(jb.clamped) == 0 and int(jb.tile_count.max()) <= cap
    num_tiles = gx * gy
    n = means.shape[0]
    feats = jnp.concatenate([prep.T.reshape(n, 9), prep.center, prep.normal,
                             jnp.asarray(colors), op[:, None]], axis=-1)
    gdata, counts = jbuild_gdata(feats, jb, num_tiles, jcfg)
    k3 = np.asarray(blend_tiles_pallas(gdata, counts, num_tiles, gx,
                                       cap // 128))
    wq, wt, first, last, overflow = build_work_queue(feats, jb, num_tiles,
                                                     jcfg)
    assert int(overflow) == 0
    k1 = np.asarray(blend_tiles_wq(wq, wt, wt, first, last, num_tiles, gx,
                                   jcfg.pair_cap // jcfg.chunk))
    out = blend_fwd_segments_plain(T(gdata), T(counts), gx, seg=64).numpy()
    for ref, name in ((k3, "K3"), (k1, "K1")):
        np.testing.assert_allclose(out[:, IMG_ROWS], ref[:, IMG_ROWS], **IMG,
                                   err_msg=name)
        np.testing.assert_allclose(out[:, AUX_ROWS], ref[:, AUX_ROWS], **AUX,
                                   err_msg=name)


def _splat_rows(opacities, depth=None, seed=0):
    """Hand-made pair rows [1, L, NFEAT] of one 16x16 tile: screen-aligned
    splats so wide that every pixel sees alpha = opacity exactly (the
    response's exp rounds to 1), at increasing depths, with seeded
    colours and normals."""
    n = len(opacities)
    rs = np.random.RandomState(seed)
    d = np.linspace(1.0, 2.0, n) if depth is None else np.asarray(depth)
    a = 1e6 * d
    rows = np.zeros((1, n, NFEAT), np.float32)
    rows[0, :, 0] = a
    rows[0, :, 2] = 8.0 * d
    rows[0, :, 4] = a
    rows[0, :, 5] = 8.0 * d
    rows[0, :, 8] = d
    rows[0, :, 9:11] = 8.0
    rows[0, :, 11:14] = rs.normal(size=(n, 3))
    rows[0, :, 14:17] = rs.uniform(size=(n, 3))
    rows[0, :, 17] = opacities
    return torch.from_numpy(rows)


def _plain_of(rows, count=None):
    count = rows.shape[1] if count is None else count
    lane = torch.arange(8)
    return blend_walk(lambda c0: rows[:, torch.clamp_max(
        c0 + lane, rows.shape[1] - 1)], torch.tensor([count]), 1, 8,
        torch.arange(1), checkpoints=8)


def test_termination_in_a_middle_segment():
    """Alpha 0.5 at 32 pairs in four 8-pair segments: every pixel's 14th
    pair would take T to 0.5^14 < 1e-4, so it trips in segment 1; the
    fold stops there (segments 2 and 3 enter below the cutoff), and the
    state, checkpoints and records equal the plain walk's."""
    rows = _splat_rows(np.full(32, 0.5))
    st, ck, rec = blend_fwd_segments_plain(rows, torch.tensor([32]), 1,
                                           seg=8, train=True)
    ref, ck_ref, rec_ref = _plain_of(rows)
    _judge(st, ref, "trip in segment 1")
    assert bool((st[:, ROW_DONE] == 1).all())
    assert bool((st[:, ROW_N_EVAL] == 14).all())
    assert bool((st[:, ROW_N_BLEND] == 13).all())
    torch.testing.assert_close(ck, ck_ref, **AUX)
    assert torch.equal(rec, rec_ref)
    assert bool((rec[:, 0] == 12).all()) and bool((rec[:, 1] == 0).all())


@pytest.mark.parametrize("t_after_8,median", [(0.52, 8), (0.48, 7)])
def test_median_at_a_segment_boundary(t_after_8, median):
    """T crosses 0.5 at the boundary between 8-pair segments 0 and 1:
    just above 0.5 after pair 7 the median is pair 8, the first of
    segment 1; just below, pair 7, the last of segment 0."""
    op = np.full(24, 0.01)
    t7 = 0.99 ** 7
    op[7] = 1.0 - t_after_8 / t7
    op[8] = 0.3
    rows = _splat_rows(op)
    st, _, rec = blend_fwd_segments_plain(rows, torch.tensor([24]), 1, seg=8,
                                          train=True)
    ref, _, rec_ref = _plain_of(rows)
    _judge(st, ref, "median at a boundary")
    assert bool((rec[:, 1] == median).all())
    assert torch.equal(rec, rec_ref)
    depth = float(rows[0, median, 8])
    torch.testing.assert_close(st[:, ROW_MED_D], torch.full((1, PIX), depth))


def test_every_pixel_done_before_the_last_segment():
    """Splats of seeded widths and opacities, so pixels trip at different
    pairs, all before the last of five 8-pair segments: the state and
    records equal the plain walk's at segments of 8 and 16."""
    rs = np.random.RandomState(4)
    n = 40
    rows = _splat_rows(rs.uniform(0.3, 0.9, size=n))
    rows[0, :, 0] = rows[0, :, 4] = torch.from_numpy(
        rs.uniform(4.0, 40.0, size=n).astype(np.float32)) * rows[0, :, 8]
    rows[0, :, 9:11] = torch.from_numpy(
        rs.uniform(0.0, 16.0, size=(n, 2)).astype(np.float32))
    rows[0, :, 2] = rows[0, :, 9] * rows[0, :, 8]
    rows[0, :, 5] = rows[0, :, 10] * rows[0, :, 8]
    ref, _, rec_ref = _plain_of(rows)
    assert bool((ref[:, ROW_DONE] == 1).all())
    n_eval = ref[:, ROW_N_EVAL]
    assert float(n_eval.max()) <= 32 and float(n_eval.min()) < float(
        n_eval.max())
    for seg in (8, 16):
        st, _, rec = blend_fwd_segments_plain(rows, torch.tensor([n]), 1,
                                              seg=seg, train=True)
        _judge(st, ref, f"seg {seg}")
        assert torch.equal(rec, rec_ref)


def test_fold_stops_at_the_trip():
    """After a trip in segment 1, segment 2's T_in set just above the
    cutoff (as rounding can leave it): segment 2 walks and blends, and
    the fold must still stop at segment 1's trip."""
    op = np.full(32, 0.5)
    rows = _splat_rows(op)
    ref = blend_fwd_segments_plain(rows, torch.tensor([32]), 1, seg=8)
    t_in = torch.ones((1, 4, PIX))
    t_in[:, 1] = 0.5 ** 8
    t_in[:, 2] = 2.0 * T_CUTOFF
    t_in[:, 3] = 0.5 * T_CUTOFF
    out = blend_fwd_segments_plain(rows, torch.tensor([32]), 1, seg=8,
                                   t_in=t_in)
    assert torch.equal(out, ref)
    assert bool((out[:, ROW_N_EVAL] == 14).all())


def test_fold_rewalks_a_segment_entered_below_the_cutoff():
    """A pixel whose walk ends segment 1 alive but whose T_in of segment 2
    lies below the cutoff (rounding the other way) trips at segment 2's
    first kept pair, as a sequential walk would from that T: its
    accumulators are those after 16 pairs, and it evaluated one pair
    more; a pair skipped at the start of segment 2 adds one evaluation."""
    op = np.full(32, 0.1)
    op[16] = 0.0                  # skipped: alpha below 1/255
    rows = _splat_rows(op)
    t_in = torch.ones((1, 4, PIX))
    t_in[:, 1] = 0.9 ** 8
    t_in[:, 2] = 0.5 * T_CUTOFF
    t_in[:, 3] = 0.25 * T_CUTOFF
    st, _, rec = blend_fwd_segments_plain(rows, torch.tensor([32]), 1, seg=8,
                                          train=True, t_in=t_in)
    upto, _, rec16 = _plain_of(rows, count=16)
    keep = [r for r in range(NSTATE) if r not in (ROW_DONE, ROW_N_EVAL)]
    torch.testing.assert_close(st[:, keep], upto[:, keep], **AUX)
    assert bool((st[:, ROW_DONE] == 1).all())
    assert bool((st[:, ROW_N_EVAL] == 16 + 2).all())
    assert torch.equal(rec, rec16)
    assert float(st[0, ROW_T, 0]) > T_CUTOFF


@pytest.mark.parametrize("seg", [8, 256])
@pytest.mark.parametrize("kind", ["opaque", "packed"])
def test_training_mode_feeds_the_segmented_backward(views, kind, seg):
    """In training mode the emulation's checkpoints and records equal the
    plain walk's (blend_walk(checkpoints=seg)) within the tolerances, and
    the segment-parallel backward fed from them matches autograd through
    the plain blend on both routes."""
    v = views[kind]
    st, ck, rec = blend_fwd_segments_plain(v.gdata, v.counts, v.gx, seg=seg,
                                           train=True)
    cap = v.gdata.shape[1]
    lane = torch.arange(8)
    ref, ck_ref, rec_ref = blend_walk(
        lambda c0: v.gdata[:, torch.clamp_max(c0 + lane, cap - 1)], v.counts,
        v.gx, 8, torch.arange(v.counts.shape[0]), checkpoints=seg)
    _judge(st, ref, f"{kind} seg {seg}")
    assert ck.shape == ck_ref.shape
    torch.testing.assert_close(ck[:, :, [0, 3, 4, 5]],
                               ck_ref[:, :, [0, 3, 4, 5]], **IMG)
    torch.testing.assert_close(ck, ck_ref, **AUX)
    assert torch.equal(rec, rec_ref)
    g = torch.randn((v.counts.shape[0], NSTATE, PIX),
                    generator=torch.Generator().manual_seed(3))
    g[:, list(DEAD_ROWS)] = 0.0
    d = blend_bwd_segments_plain(v.gdata, v.counts, v.gx, g, seg=seg,
                                 forward=(st, ck, rec))
    d_ref = blend_dense_plain_vjp(v.gdata, v.counts, v.gx, g)
    scale = d_ref.abs().amax(dim=(0, 1)) + 1e-30
    torch.testing.assert_close(d / scale, d_ref / scale, **GRAD)
    rows, index = _tile_rows(v.fs, v.binning)
    d_rows = blend_bwd_segments_plain(rows, v.binning.tile_count, v.gx, g,
                                      seg=seg, forward=(st, ck, rec))
    valid = index >= 0
    d_sorted = torch.zeros((v.fs.shape[0], NFEAT)).index_add_(
        0, index[valid], d_rows[valid])
    d_wq = blend_tiles_plain_vjp(v.fs, *v.args, g)
    scale = d_wq.abs().amax(dim=0) + 1e-30
    torch.testing.assert_close(d_sorted / scale, d_wq / scale, **GRAD)
    assert float(st[:, ROW_T].min()) < 1.0



def _judged(changes):
    """compare_states on two states that differ at one pixel: ``changes``
    maps a row to its (kernel, reference) values there.  Returns the
    flipped and outside-tolerance counts and the kinds whose mask holds
    that pixel (and no other)."""
    ref = torch.zeros((2, NSTATE, PIX))
    ref[:, ROW_T] = 0.5
    out = ref.clone()
    for r, (k, p) in changes.items():
        out[0, r, 7], ref[0, r, 7] = k, p
    res = compare_states(out, ref)
    kinds = []
    for kind, mask in res["masks"].items():
        assert int(mask.sum()) == int(bool(mask[0, 7]))
        if bool(mask[0, 7]):
            kinds.append(kind)
    assert res["flips"] == {k: int(k in kinds)
                            for k in ("done", "median", "trip_moved")}
    return res["flipped"], res["bad_outside_flips"], kinds


def test_compare_states_sorts_threshold_flips():
    """compare_states counts as flips the pixels whose termination or
    median choice differs, a termination at another pair included when
    the side that blended the extra pair ends within 1e-5 of T_CUTOFF
    (the case seen at full width, tools/blend_fwd_flips.py); the same
    counts with T far from the cutoff, or differing counts of a pixel
    that did not terminate, stay outside the tolerance.  Each pixel is
    counted in one kind: a termination that also moves the median is a
    done flip."""
    trip = {ROW_DONE: (1.0, 1.0), ROW_N_EVAL: (129.0, 130.0),
            ROW_N_BLEND: (34.0, 35.0)}
    assert _judged({}) == (0, 0, [])
    assert _judged({ROW_DONE: (1.0, 0.0)}) == (1, 0, ["done"])
    assert _judged({ROW_DONE: (1.0, 0.0),
                    ROW_MED_D: (1.5, 2.5)}) == (1, 0, ["done"])
    assert _judged({ROW_MED_D: (1.5, 2.5)}) == (1, 0, ["median"])
    assert _judged({**trip, ROW_T: (1.1107232e-4, 1.0000001e-4)}) == (
        1, 0, ["trip_moved"])
    assert _judged({**trip, ROW_T: (1.1107232e-4, 2e-4)}) == (0, 1,
                                                              ["other"])
    assert _judged({ROW_N_EVAL: (129.0, 130.0),
                    ROW_N_BLEND: (34.0, 35.0)}) == (0, 1, ["other"])
