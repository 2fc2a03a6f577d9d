"""The segment-parallel blend backward (K2/K4, csrc/blend_bwd.cu) as an
algorithm, on the CPU: the plain forward walk's checkpoints, the closed
form of the walk's suffix sums, the work-item and checkpoint layout, and
``blend_bwd_segments_plain`` (the plain emulation of the kernels' walk)
against the plain VJPs and against the JAX package's blend VJP (its
work-queue kernels in interpret mode).

Tolerances: the gradients as the JAX package holds its own kernels'
(tests/test_pallas_blend.py), max-normalised rtol 2e-4 atol 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_tpu.ops.tiled_raster import blend_tiles as jblend_tiles
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import (DEAD_ROWS, SEG,
                                        _check_segments,
                                        blend_bwd_segments_plain,
                                        blend_tiles_plain_vjp,
                                        segment_layout, suffix_sums)
from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_plain_vjp,
                                              build_gdata)
from d2dgs_torch.ops.projection import Preprocessed, preprocess
from d2dgs_torch.ops.tiled_raster import (CKPT_ROWS, NFEAT, NSTATE, PIX,
                                          ROW_N_BLEND, blend_tiles_plain,
                                          blend_walk, pack_features)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

H, W = 48, 64
GRAD = dict(rtol=2e-4, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def _tile_rows(feats_sorted, binning):
    """Each tile's pair rows [T, L, NFEAT] (zero past its count) and the
    sorted-feature row of each, -1 past the count."""
    count = binning.tile_count.long()
    lane = torch.arange(int(count.max()))
    valid = lane[None, :] < count[:, None]
    src = torch.clamp(binning.tile_start.long()[:, None] + lane[None, :], 0,
                      binning.pair_rank.shape[0] - 1)
    index = torch.where(valid, binning.pair_rank.long()[src], -1)
    rows = torch.where(valid[..., None], feats_sorted[index.clamp_min(0)],
                       0.0)
    return rows, index


def _scatter(d_rows, index, n):
    """Per-pair row gradients [T, L, NFEAT] -> [n, NFEAT] summed per row."""
    valid = index >= 0
    return torch.zeros((n, NFEAT)).index_add_(0, index[valid],
                                               d_rows[valid])


class View:
    """One scene's blend inputs on both routes, a seeded cotangent with
    the dead rows zeroed, and the plain VJPs."""

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
        self.g = torch.randn((self.gx * gy, NSTATE, PIX),
                             generator=torch.Generator().manual_seed(3))
        self.g[:, list(DEAD_ROWS)] = 0.0
        b = self.binning
        self.args = (b.pair_rank, b.tile_start, b.tile_count, self.gx)
        self.d_dense = blend_dense_plain_vjp(self.gdata, self.counts,
                                             self.gx, self.g)
        self.d_tiles = blend_tiles_plain_vjp(self.fs, *self.args, self.g)


@pytest.fixture(scope="module")
def views():
    return {kind: View(kind) for kind in ("pallas", "opaque", "packed")}


def _close(out, ref, what):
    """Max-normalised per feature column, as chip_smoke.py compares."""
    out, ref = out.reshape(-1, NFEAT), ref.reshape(-1, NFEAT)
    scale = ref.abs().amax(dim=0) + 1e-30
    assert bool((ref.abs().amax(dim=0) > 0).all()), what
    torch.testing.assert_close(out / scale, ref / scale, **GRAD, msg=what)


@pytest.mark.parametrize("seg", [8, 64, 256])
@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_segments_plain_matches_plain_vjps(views, kind, seg):
    """The emulation of the segment-parallel walk equals autograd through
    the plain blend on both routes (K4's per-pair rows, K2's sorted rows
    summed over tiles), at segments of 8 pairs up to the kernels' 256."""
    v = views[kind]
    if kind == "packed":      # the last pair with a gradient
        used = v.d_dense.abs().sum(-1) > 0
        n_walk = int(torch.max(used * torch.arange(1, used.shape[1] + 1)))
        assert n_walk > 2 * SEG, "the packed scene must span 3 segments"
    d_rows = blend_bwd_segments_plain(v.gdata, v.counts, v.gx, v.g, seg=seg)
    _close(d_rows, v.d_dense, f"dense {kind} seg {seg}")
    rows, index = _tile_rows(v.fs, v.binning)
    d_sorted = _scatter(
        blend_bwd_segments_plain(rows, v.binning.tile_count, v.gx, v.g,
                                 seg=seg), index, v.fs.shape[0])
    _close(d_sorted, v.d_tiles, f"work queue {kind} seg {seg}")


@pytest.mark.parametrize("seg", [8, 64])
def test_plain_forward_checkpoints(views, seg):
    """blend_walk's checkpoint k equals the plain blend of the same lists
    clamped at k * seg, on all 11 checkpointed rows; its records hold each
    pixel's last blended pair (blending up to it gives the whole state)."""
    v = views["packed"]
    count = v.binning.tile_count
    chunk = 8
    lane = torch.arange(chunk)
    cap = v.gdata.shape[1]
    rows_of = lambda c0: v.gdata[:, torch.clamp_max(c0 + lane, cap - 1)]
    state, ckpt, records = blend_walk(rows_of, v.counts, v.gx, chunk,
                                      torch.arange(count.shape[0]),
                                      checkpoints=seg)
    n_ck = -(-int(count.max()) // seg) - 1
    assert ckpt.shape == (count.shape[0], n_ck, len(CKPT_ROWS), PIX)
    for k in range(1, n_ck + 1):
        clamped = blend_tiles_plain(v.fs, v.binning.pair_rank,
                                    v.binning.tile_start,
                                    torch.clamp_max(count, k * seg), v.gx,
                                    chunk=chunk)
        torch.testing.assert_close(ckpt[:, k - 1],
                                   clamped[:, list(CKPT_ROWS)], rtol=0,
                                   atol=0)
    torch.testing.assert_close(
        state, blend_tiles_plain(v.fs, *v.args, chunk=chunk), rtol=0, atol=0)
    last = records[:, 0].long()
    assert bool(((last >= 0) == (state[:, ROW_N_BLEND] > 0)).all())
    assert int(records[:, 1].max()) >= 0
    assert bool((records[:, 1] <= records[:, 0]).all())
    # the pairs up to each tile's last blended one give every accumulator
    # (the done flag aside: a pixel's dropped trip pair may lie past it)
    upto = blend_tiles_plain(v.fs, v.binning.pair_rank, v.binning.tile_start,
                             (last.amax(dim=1) + 1).to(torch.int32), v.gx,
                             chunk=chunk)
    acc = [0] + list(range(2, ROW_N_BLEND - 1))
    torch.testing.assert_close(upto[:, acc], state[:, acc], rtol=0, atol=0)


def _pixel_sequences(n, pixels, dtype, seed=0):
    """Random front-to-back pair sequences of ``pixels`` pixels: per pair
    alpha (0 for a skipped pair), depth, colour and normal; the forward
    state after every pair ([n + 1, NCKPT, P], CKPT_ROWS' order), the
    median pair, its weight and the per-pair pre-blend values."""
    rs = np.random.RandomState(seed)
    alpha = rs.uniform(1 / 255, 0.3, size=(n, pixels))
    alpha[rs.uniform(size=(n, pixels)) < 0.3] = 0.0
    depth = rs.uniform(0.5, 5.0, size=(n, pixels))
    col = rs.uniform(size=(n, 3, pixels))
    nrm = rs.normal(size=(n, 3, pixels))
    m_of = lambda d: (100.0 * d - 20.0) / (99.8 * d)
    cast = lambda a: np.asarray(a, dtype)
    alpha, depth, col, nrm = map(cast, (alpha, depth, col, nrm))
    st = np.zeros((n + 1, 11, pixels), dtype)
    st[0, 0] = 1.0
    med = np.full(pixels, -1)
    med_w = np.zeros(pixels, dtype)
    for i in range(n):
        s = st[i].copy()
        a = alpha[i]
        Tb, D1, D2 = s[0], s[1], s[2]
        w = a * Tb
        m = cast(m_of(depth[i]))
        err = m * m * (1 - Tb) + D2 - 2 * m * D1
        s[0] = Tb * (1 - a)
        s[1] = D1 + w * m
        s[2] = D2 + w * m * m
        s[3:6] += w * col[i]
        s[6] += w * depth[i]
        s[7:10] += w * nrm[i]
        s[10] += err * w
        is_med = (a > 0) & (Tb > 0.5)
        med = np.where(is_med, i, med)
        med_w = np.where(is_med, w, med_w)
        st[i + 1] = s
    return alpha, depth, col, nrm, st, med, med_w


def _recurrence(alpha, depth, col, nrm, st, med, g):
    """The backward walk's running sums (csrc/blend_bwd.cu) at every
    boundary e = n .. 0, stepped pair by pair from the end, float64."""
    n = alpha.shape[0]
    f = lambda a: np.asarray(a, np.float64)
    alpha, depth, col, nrm, st = map(f, (alpha, depth, col, nrm, st))
    g = f(g)
    T_f = st[n, 0]
    Q = g[0] * T_f
    sum_w = np.zeros_like(T_f)
    sum_wm = np.zeros_like(T_f)
    out = {n: (sum_w.copy(), sum_wm.copy(), Q.copy())}
    for i in range(n - 1, -1, -1):
        a = alpha[i]
        Tb, D1b, D2b = st[i, 0], st[i, 1], st[i, 2]
        w = a * Tb
        m = (100.0 * depth[i] - 20.0) / (99.8 * depth[i])
        wm = w * m
        err = m * m * (1 - Tb) + D2b - 2 * m * D1b
        S1 = -2 * g[11] * sum_wm
        S2 = g[11] * sum_w
        wbar = (np.sum(g[4:7] * col[i], 0) + np.sum(g[8:11] * nrm[i], 0)
                + g[7] * depth[i] + g[11] * err + m * S1 + m * m * S2
                + np.where(med == i, g[13], 0.0))
        blended = a > 0
        Q = np.where(blended, Q + wbar * w - g[11] * wm * m * Tb, Q)
        sum_w = np.where(blended, sum_w + w, sum_w)
        sum_wm = np.where(blended, sum_wm + wm, sum_wm)
        out[i] = (sum_w.copy(), sum_wm.copy(), Q.copy())
    return out


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-6)])
def test_closed_form_suffix_matches_recurrence(dtype, tol):
    """``suffix_sums`` from the forward state at a boundary and the final
    state equals the walk's pair-by-pair recurrence at every boundary,
    the median's own included: to 1e-12 in float64; in float32 (the
    kernels' type) to 2e-6 of each sum's largest value."""
    n, pixels = 40, 64
    alpha, depth, col, nrm, st, med, med_w = _pixel_sequences(n, pixels,
                                                              dtype)
    g = np.random.RandomState(1).normal(size=(NSTATE, pixels)).astype(dtype)
    g[list(DEAD_ROWS)] = 0.0
    ref = _recurrence(alpha, depth, col, nrm, st, med, g)
    assert (med > 0).any() and (med < n - 1).any()
    final = torch.from_numpy(st[n])
    scales = [max(np.abs(r).max(), 1.0) for r in ref[0]]
    for e in range(n + 1):
        got = suffix_sums(torch.from_numpy(st[e]), final, torch.from_numpy(g),
                          torch.from_numpy(med_w), torch.from_numpy(med >= e))
        for name, x, y, scale in zip(("sum_w", "sum_wm", "Q"), got, ref[e],
                                     scales):
            np.testing.assert_allclose(x.numpy().astype(np.float64) / scale,
                                       y / scale, rtol=0, atol=tol,
                                       err_msg=f"{name} at boundary {e}")


@pytest.mark.parametrize("seg", [8, 256])
def test_segment_layout_covers_each_walked_pair_once(seg):
    """Every (tile, pair < n_walk) falls in exactly one work item's
    segment for any walk length n_walk <= count; items number T plus the
    checkpoints, and each item's checkpoint lies in its own tile's run."""
    rs = np.random.RandomState(seg)
    counts = rs.randint(0, 6 * seg, size=40)
    counts[:4] = [0, seg, 2 * seg, 2 * seg + 1]
    n_walk = np.array([rs.randint(0, c + 1) for c in counts])
    n_walk[1:3] = counts[1:3]
    lay = segment_layout(torch.as_tensor(counts, dtype=torch.int32), seg)
    n_ck = np.maximum(-(-counts // seg) - 1, 0)
    assert lay.ckpt.shape == (n_ck.sum(), len(CKPT_ROWS), PIX)
    assert lay.items.shape == (counts.shape[0] + n_ck.sum(), 2)
    off = lay.ckpt_off.numpy()
    np.testing.assert_array_equal(off, np.cumsum(n_ck) - n_ck)
    tile, seg_of = lay.items.numpy().T
    cover = [np.zeros(c, int) for c in counts]
    for t, s in zip(tile, seg_of):
        assert 0 <= s < max(1, -(-counts[t] // seg))
        lo, hi = s * seg, min(s * seg + seg, n_walk[t])
        cover[t][lo:hi] += 1
        if hi < n_walk[t]:         # walks from a checkpoint of its tile
            assert off[t] <= off[t] + s < off[t] + n_ck[t]
    for c, w, cv in zip(counts, n_walk, cover):
        np.testing.assert_array_equal(cv[:w], 1)
        np.testing.assert_array_equal(cv[w:], 0)


@pytest.mark.parametrize("seg", [8, 512])
def test_kernel_checks_reject_other_segment_length(seg):
    """The kernels walk SEG-pair segments: a layout at any other length
    has the right shapes for its own items, and the wrappers' check
    refuses it; the SEG layout of the same counts passes."""
    counts = torch.as_tensor([0, 3 * SEG + 5, SEG, 7], dtype=torch.int32)
    cpu = torch.device("cpu")
    assert _check_segments(segment_layout(counts), 4, cpu) == 4 + 3
    with pytest.raises(ValueError, match=f"{seg}-pair segments"):
        _check_segments(segment_layout(counts, seg), 4, cpu)


def test_segments_plain_matches_jax_k2():
    """The emulation at 8-pair segments against JAX blend_tiles on the
    work-queue kernels (K2 included) in interpret mode, as
    tests/test_torch_train.py holds the port's blend VJP: the same
    preprocessed splats and cotangents on every map channel; gradients in
    Tmat, center, normal, colour and opacity."""
    means, scales, quats, opac, colors = blend_test_scene("pallas")
    cam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)
    gx, gy = tile_grid(H, W)
    jcfg = JRasterConfig(tile_cap=256, chunk=64, pair_cap=2048,
                         emission_cap=1 << 14, use_pallas=True,
                         pallas_interpret=True, use_workqueue=True)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), cam)
    op = jnp.where(prep.valid, jnp.asarray(opac), 0.0)
    jb = jbin(prep, gx, gy, jcfg, opacity=op)
    rs = np.random.RandomState(5)
    ntile = gx * gy
    gc = rs.normal(size=(ntile, PIX, 3)).astype(np.float32)
    ga = rs.normal(size=(ntile, PIX, 8)).astype(np.float32)
    inputs = (prep.T, prep.center, prep.normal, jnp.asarray(colors), op)

    def jloss(*x):
        c, a, _ = jblend_tiles(*x, jb, gx, gy, jcfg)
        return jnp.sum(c * gc) + jnp.sum(a * ga)

    jg = jax.grad(jloss, argnums=range(5))(*inputs)

    # the same cotangent on the state rows (ops/tiled_raster.state_to_maps)
    g = torch.zeros((ntile, NSTATE, PIX))
    g[:, 4:7] = T(gc).transpose(1, 2)
    for r, ch, sign in ((7, 0, 1.0), (0, 1, -1.0), (8, 2, 1.0),
                        (9, 3, 1.0), (10, 4, 1.0), (12, 5, 1.0),
                        (11, 6, 1.0), (13, 7, 1.0)):
        g[:, r] = sign * T(ga[..., ch])
    tp = Preprocessed(*(T(a) for a in prep))
    tb = bin_gaussians(tp, gx, gy, RasterConfig(), opacity=T(op))
    feats = pack_features(*(T(a) for a in inputs))
    order = tb.order.long()
    rows, index = _tile_rows(feats[order], tb)
    d_sorted = _scatter(blend_bwd_segments_plain(rows, tb.tile_count, gx, g,
                                                 seg=8),
                        index, feats.shape[0])
    d = torch.zeros_like(d_sorted)
    d[order] = d_sorted
    n = d.shape[0]
    tg = (d[:, 0:9].reshape(n, 3, 3), d[:, 9:11], d[:, 11:14], d[:, 14:17],
          d[:, 17])
    for name, x, y in zip(("Tmat", "center", "normal", "colors", "opacity"),
                          tg, jg):
        y = np.asarray(y)
        scale = np.abs(y).max() + 1e-12
        assert scale > 1e-12, name
        np.testing.assert_allclose(x.numpy() / scale, y / scale, **GRAD,
                                   err_msg=name)
