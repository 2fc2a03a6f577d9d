"""Port parity, the 3DGS flow rasterizer (d2dgs_torch/ops/raster3d.py)
against d2dgs_tpu/ops/raster3d.py on the same numpy inputs, and against
the brute-force dense oracle of tests/test_raster3d.py.

Tolerances: integer outputs (radius, valid, rects, tile lists) bitwise;
the preprocess's floats as test_torch_core.test_preprocess_parity holds
the surfel preprocess (rtol/atol 1e-6), the conic row-normalised since
it divides by a determinant; image and alpha to 2e-5 and depth to 2e-4
(test_raster3d.py's oracle tolerances), against both JAX and the oracle;
gradients of the five inputs max-normalised to 2e-4 (the repo's
gradient tolerance).  The JAX side runs under its RasterConfig with
pair_cap 4096, far above these scenes' pair counts (no pair dropped)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import (ALPHA_CLIP, ALPHA_CUTOFF, T_CUTOFF,
                              RasterConfig as JRasterConfig)
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.ops import raster3d as j3
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.binning import opacity_radius as jopacity_radius
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.ops import raster3d as t3
from d2dgs_torch.ops.binning import bin_gaussians as tbin
from d2dgs_torch.ops.binning import opacity_radius

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

JCFG = JRasterConfig(tile_cap=256, chunk=64, pair_cap=4096,
                     use_pallas=False)
TCFG = RasterConfig(tile_cap=256, chunk=64)
TOL = dict(rtol=1e-6, atol=1e-6)
CAM = dict(azimuth=0.3, elevation=0.2, radius=4.0, fov=0.8, H=32, W=32)
CAM2 = dict(azimuth=-0.7, elevation=0.4, radius=3.5, fov=0.7, H=37, W=45,
            time=0.6)


def T(a):
    return torch.from_numpy(np.array(a))


def scene(n=24, seed=0, s3=True, opaque=False, spread=0.5, size=0.15):
    rs = np.random.RandomState(seed)
    means = rs.normal(size=(n, 3)) * spread
    scales = np.exp(rs.normal(size=(n, 3 if s3 else 2)) * 0.3) * size
    quats = rs.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (np.full(n, 0.99) if opaque
            else rs.uniform(0.3, 0.9, size=n))
    colors = rs.uniform(size=(n, 3))
    return [np.asarray(a, np.float32)
            for a in (means, scales, quats, opac, colors)]


def dense_3dgs(means3d, scales, quats, opac, colors, cam, bg):
    """Per-pixel loop over every Gaussian in depth order: the oracle of
    tests/test_raster3d.py, on the port's preprocess."""
    prep = t3.preprocess3d(T(means3d), T(scales), T(quats), cam)
    order = np.argsort(np.where(prep.valid.numpy(), prep.depth.numpy(),
                                np.inf), kind="stable")
    con = prep.conic.numpy()[order]
    cen = prep.center.numpy()[order]
    dep = prep.depth.numpy()[order]
    op = np.asarray(opac)[order] * prep.valid.numpy()[order]
    col = np.asarray(colors)[order]
    H, W, C = cam.H, cam.W, colors.shape[-1]
    img = np.zeros((H, W, C))
    depth = np.zeros((H, W))
    alpha_img = np.zeros((H, W))
    for y in range(H):
        for x in range(W):
            Tr = 1.0
            for g in range(len(op)):
                dx, dy = cen[g, 0] - x, cen[g, 1] - y
                power = (-0.5 * (con[g, 0] * dx * dx + con[g, 2] * dy * dy)
                         - con[g, 1] * dx * dy)
                if power > 0:
                    continue
                a = min(ALPHA_CLIP, op[g] * np.exp(power))
                if a < ALPHA_CUTOFF:
                    continue
                if Tr <= T_CUTOFF:
                    break
                img[y, x] += col[g] * a * Tr
                depth[y, x] += dep[g] * a * Tr
                Tr *= 1.0 - a
            img[y, x] += Tr * np.asarray(bg)
            alpha_img[y, x] = 1.0 - Tr
    return img, depth, alpha_img


def _both(arrs, kw, jcfg=JCFG, tcfg=TCFG, bg=(0.1, 0.2, 0.3)):
    m, s, q, o, c = arrs
    jcam, tcam = jorbit(**kw), orbit_camera(**kw, device="cpu")
    j = jax.jit(lambda *a: j3.rasterize_3dgs(
        *a, cam=jcam, bg=jnp.asarray(bg), cfg=jcfg))(
        *map(jnp.asarray, arrs))
    t = t3.rasterize_3dgs(T(m), T(s), T(q), T(o), T(c), tcam,
                          bg=torch.tensor(bg), cfg=tcfg)
    return [np.asarray(x) for x in j], [x.numpy() for x in t], tcam


def _check_outputs(j, t):
    np.testing.assert_array_equal(t[1], j[1])                  # radii
    np.testing.assert_allclose(t[0], j[0], atol=2e-5)
    np.testing.assert_allclose(t[2], j[2], atol=2e-4)
    np.testing.assert_allclose(t[3], j[3], atol=2e-5)


def test_cov3d_parity():
    _, s, q, _, _ = scene(40, seed=1)
    for scales in (s, s[:, :2]):
        j = np.asarray(j3.compute_cov3d(jnp.asarray(scales), jnp.asarray(q),
                                        1.3))
        t = t3.compute_cov3d(T(scales), T(q), 1.3).numpy()
        # off-diagonal entries cancel terms of the diagonal's size:
        # compare row-normalised, as T in test_preprocess_parity
        scale = np.abs(j).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(t / scale, j / scale, **TOL)
    # the JAX package's own isotropic case
    cov = t3.compute_cov3d(torch.full((4, 3), 0.2),
                           torch.tensor([[1.0, 0, 0, 0]]).repeat(4, 1))
    np.testing.assert_allclose(cov[:, [0, 3, 5]], 0.04, atol=1e-7)
    np.testing.assert_allclose(cov[:, [1, 2, 4]], 0.0, atol=1e-7)


@pytest.mark.parametrize("kw", [CAM, CAM2])
@pytest.mark.parametrize("s3", [True, False])
def test_preprocess3d_parity(kw, s3):
    m, s, q, _, _ = scene(160, seed=2, s3=s3)
    j = j3.preprocess3d(jnp.asarray(m), jnp.asarray(s), jnp.asarray(q),
                        jorbit(**kw), 1.1)
    t = t3.preprocess3d(T(m), T(s), T(q), orbit_camera(**kw, device="cpu"),
                        1.1)
    for f in ("radius", "valid", "rect_min", "rect_max"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("center", "depth"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), **TOL)
    # the conic is cov2d / det with det = cxx cyy - cxy^2: its rounding
    # is that of the row, magnified by the cancellation in det, the
    # factor (cxx cyy + cxy^2) / det = (a c + b^2) / (a c - b^2)
    jc = np.asarray(j.conic, np.float64)
    a, b, c = jc[:, 0], jc[:, 1], jc[:, 2]
    cond = (a * c + b * b) / (a * c - b * b)
    scale = np.abs(jc).max(axis=-1, keepdims=True) * cond[:, None]
    np.testing.assert_allclose(t.conic.numpy() / scale, jc / scale, **TOL)
    assert t.valid.sum() > 100


def test_binning_3dgs_bitwise():
    """The conic law's circle cull (opacity_radius with sigma = radius/3,
    corner samples) bins the 3DGS splats into the JAX tile lists."""
    m, s, q, o, _ = scene(160, seed=3, spread=0.4)
    o[:8] = 0.003                          # below 1/255: culled outright
    jcam, tcam = jorbit(**CAM2), orbit_camera(**CAM2, device="cpu")
    jp = j3.preprocess3d(*map(jnp.asarray, (m, s, q)), jcam)
    tp = t3.preprocess3d(T(m), T(s), T(q), tcam)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    gx, gy = tile_grid(tcam.H, tcam.W)
    jop = jnp.where(jp.valid, jnp.asarray(o), 0.0)
    top = torch.where(tp.valid, T(o), 0.0)
    # the circle's radius to float rounding (log and sqrt), the lists
    # below bitwise
    np.testing.assert_allclose(
        opacity_radius(tp.radius, top, sigma=tp.radius.float() / 3.0)
        .numpy(),
        np.asarray(jopacity_radius(jp.radius, jop,
                                   sigma=jp.radius.astype(jnp.float32)
                                   / 3.0)), **TOL)
    jb = jbin(j3._as_surfel_prep(jp), gx, gy, JCFG, opacity=jop,
              cull_sigma=jp.radius.astype(jnp.float32) / 3.0,
              pixel_offset=0.0)
    tb = tbin(t3._as_surfel_prep(tp), gx, gy, TCFG, opacity=top,
              cull_sigma=tp.radius.float() / 3.0, pixel_offset=0.0)
    n = int(jb.num_pairs)
    assert n == int(tb.num_pairs) and 0 < n < JCFG.pair_cap
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.pair_rank.numpy(),
                                  np.asarray(jb.pair_rank)[:n])
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.tile_count.numpy(),
                                  np.asarray(jb.tile_count))
    # the cull removed pairs the plain rect binning keeps
    plain = tbin(t3._as_surfel_prep(tp), gx, gy, TCFG)
    assert int(plain.num_pairs) > n


@pytest.mark.parametrize("opaque", [False, True])
def test_forward_matches_jax_and_dense_oracle(opaque):
    arrs = scene(24, seed=0, opaque=opaque)
    j, t, tcam = _both(arrs, CAM)
    _check_outputs(j, t)
    ref_img, ref_depth, ref_alpha = dense_3dgs(*arrs, tcam,
                                               np.array([0.1, 0.2, 0.3]))
    np.testing.assert_allclose(t[0], ref_img, atol=2e-5)
    np.testing.assert_allclose(t[2][..., 0], ref_depth, atol=2e-4)
    np.testing.assert_allclose(t[3][..., 0], ref_alpha, atol=2e-5)
    assert (t[1] > 0).sum() > 0


def test_opaque_scene_terminates_early():
    """Forty opaque splats stacked on the view axis: every covered pixel
    stops at T <= 1e-4 after a few of them, in both packages, over more
    than one chunk of pairs."""
    rs = np.random.RandomState(5)
    n = 160
    means = np.concatenate([rs.normal(size=(n, 2)) * 0.05,
                            rs.normal(size=(n, 1)) * 0.3], -1)
    arrs = [np.asarray(means, np.float32),
            np.full((n, 3), 0.4, np.float32),
            np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
            np.full(n, 0.99, np.float32),
            rs.uniform(size=(n, 3)).astype(np.float32)]
    kw = dict(azimuth=0.0, elevation=0.0, radius=4.0, fov=0.8, H=32, W=32)
    j, t, _ = _both(arrs, kw)
    _check_outputs(j, t)
    # the centre pixels are fully opaque: T hit the cutoff
    assert t[3][12:20, 12:20].min() >= 1.0 - T_CUTOFF
    tp = t3.preprocess3d(*map(T, arrs[:3]), orbit_camera(**kw,
                                                         device="cpu"))
    assert int(tp.valid.sum()) > TCFG.chunk


@pytest.mark.parametrize("tile_cap, chunk", [(100, 32), (40, 64)])
def test_tile_cap_off_a_multiple_of_chunk(tile_cap, chunk):
    """At most floor(tile_cap / chunk) * chunk pairs of a tile are
    blended (at least one chunk), as the JAX scan walks them."""
    arrs = scene(200, seed=6, spread=0.3, size=0.1)
    jcfg = JRasterConfig(tile_cap=tile_cap, chunk=chunk, pair_cap=1 << 14,
                         use_pallas=False)
    tcfg = RasterConfig(tile_cap=tile_cap, chunk=chunk)
    j, t, tcam = _both(arrs, CAM, jcfg, tcfg)
    _check_outputs(j, t)
    # the cap cut some tile: the uncapped render differs
    full = t3.rasterize_3dgs(*map(T, arrs), tcam,
                             bg=torch.tensor([0.1, 0.2, 0.3]),
                             cfg=RasterConfig(tile_cap=1024, chunk=chunk))
    assert np.abs(full[0].numpy() - t[0]).max() > 1e-3


def test_gradient_parity():
    arrs = scene(24, seed=7)
    jcam = jorbit(**CAM)
    tcam = orbit_camera(**CAM, device="cpu")
    w = np.random.RandomState(8).uniform(size=(32, 32, 5)).astype(
        np.float32)

    def jloss(*a):
        img, _, depth, alpha = j3.rasterize_3dgs(*a, jcam, cfg=JCFG)
        return jnp.sum(jnp.concatenate([img, depth, alpha], -1) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, arrs))
    ts = [T(a).requires_grad_(True) for a in arrs]
    img, _, depth, alpha = t3.rasterize_3dgs(*ts, tcam, cfg=TCFG)
    loss = torch.sum(torch.cat([img, depth, alpha], -1) * T(w))
    tg = torch.autograd.grad(loss, ts)
    for name, a, b in zip(("means", "scales", "quats", "opac", "colors"),
                          tg, jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_walk_counts_chunks():
    """The walk stops after the chunks the fullest tile needs."""
    arrs = scene(200, seed=6, spread=0.3, size=0.1)
    tcam = orbit_camera(**CAM, device="cpu")
    for cap in (64, 256, 1024):
        t3.WALK_COUNTS.update(renders=0, chunks=0)
        t3.rasterize_3dgs(*map(T, arrs), tcam,
                          cfg=RasterConfig(tile_cap=cap, chunk=32))
        prep = t3.preprocess3d(*map(T, arrs[:3]), tcam)
        gx, gy = tile_grid(tcam.H, tcam.W)
        b = tbin(t3._as_surfel_prep(prep), gx, gy, TCFG,
                 opacity=torch.where(prep.valid, T(arrs[3]), 0.0),
                 cull_sigma=prep.radius.float() / 3.0, pixel_offset=0.0)
        need = -(-int(b.tile_count.max()) // 32)
        assert t3.WALK_COUNTS == dict(renders=1,
                                      chunks=min(need, cap // 32))
