"""Port parity, the 3DGS flow rasterizer (d2dgs_torch/ops/raster3d.py)
against d2dgs_tpu/ops/raster3d.py on the same numpy inputs, and against
the brute-force dense oracle of tests/test_raster3d.py; its plain blend
``blend3d_plain`` (the plain version of kernels K5/K6) and the CPU route
and argument checks of their wrappers (d2dgs_torch/ops/cuda/raster3d.py).

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
from d2dgs_torch.ops.cuda import raster3d as k3
from d2dgs_torch.ops.tiled_raster import _tile_pixels, tiles_to_image

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


def _blend_inputs(arrs, kw, cfg=TCFG, grad=False):
    """blend3d_plain's arguments for a scene (blend3d_inputs, as
    rasterize_3dgs builds them); with ``grad`` the five per-Gaussian
    scene inputs require a gradient (returned last)."""
    cam = orbit_camera(**kw, device="cpu")
    xs = [T(a).requires_grad_(grad) for a in arrs]
    _, args = t3.blend3d_inputs(*xs, cam, cfg=cfg)
    return args, cam, xs


def _as_images(state, cam, bg):
    """blend3d_plain's tile state -> (image, depth, alpha), as
    rasterize_3dgs assembles them."""
    Ta, Ca, Da = state
    gx, gy = tile_grid(cam.H, cam.W)
    img = tiles_to_image(Ca + Ta[..., None] * torch.tensor(bg), gx, gy,
                         cam.H, cam.W)
    depth = tiles_to_image(Da[..., None], gx, gy, cam.H, cam.W)
    alpha = tiles_to_image(1.0 - Ta[..., None], gx, gy, cam.H, cam.W)
    return img, depth, alpha


@pytest.mark.parametrize("opaque", [False, True])
def test_blend3d_plain_matches_jax(opaque):
    """blend3d_plain on the port's preprocess and binning against JAX's
    rasterize_3dgs: image and alpha to 2e-5, depth to 2e-4."""
    arrs = scene(24, seed=0, opaque=opaque)
    bg = (0.1, 0.2, 0.3)
    j, _, _ = _both(arrs, CAM, bg=bg)
    args, cam, _ = _blend_inputs(arrs, CAM)
    img, depth, alpha = _as_images(t3.blend3d_plain(*args), cam, bg)
    np.testing.assert_allclose(img.numpy(), j[0], atol=2e-5)
    np.testing.assert_allclose(depth.numpy(), j[2], atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), j[3], atol=2e-5)
    # the wrappers' CPU route is the plain walk
    for a, b in zip(k3.blend3d_fwd(*args), t3.blend3d_plain(*args)):
        assert torch.equal(a, b)


def test_blend3d_plain_vjp_matches_jax_gradients():
    """The CPU route of K6's wrapper (autograd through blend3d_plain),
    carried back through preprocess3d by autograd, against JAX's
    gradients of rasterize_3dgs in the five scene inputs, max-normalised
    to 2e-4 (as test_gradient_parity)."""
    arrs = scene(24, seed=7)
    jcam = jorbit(**CAM)
    w = np.random.RandomState(8).uniform(size=(32, 32, 5)).astype(
        np.float32)

    def jloss(*a):
        img, _, depth, alpha = j3.rasterize_3dgs(*a, jcam, cfg=JCFG)
        return jnp.sum(jnp.concatenate([img, depth, alpha], -1) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, arrs))
    args, cam, xs = _blend_inputs(arrs, CAM, grad=True)
    state = [t.detach().requires_grad_() for t in t3.blend3d_plain(
        *(a.detach() if torch.is_tensor(a) else a for a in args))]
    img, depth, alpha = _as_images(state, cam, (0.0, 0.0, 0.0))
    loss = torch.sum(torch.cat([img, depth, alpha], -1) * T(w))
    cot = torch.autograd.grad(loss, state)
    d_blend = k3.blend3d_bwd(*(a.detach() if torch.is_tensor(a) else a
                               for a in args[:9]), None, None, *cot,
                             chunk=TCFG.chunk, tile_cap=TCFG.tile_cap)
    tg = torch.autograd.grad(args[:5], xs, d_blend)
    for name, a, b in zip(("means", "scales", "quats", "opac", "colors"),
                          tg, jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("tile_cap, chunk", [(100, 32), (40, 64)])
def test_blend3d_plain_tile_cap(tile_cap, chunk):
    """blend3d_plain blends at most walk_cap(chunk, tile_cap) =
    floor(tile_cap / chunk) * chunk pairs of a tile (at least one chunk),
    the kernels' ``cap``: its state at tile_cap equals its state at that
    cap, the JAX image at tile_cap, and differs from the uncapped one."""
    arrs = scene(200, seed=6, spread=0.3, size=0.1)
    cfg = RasterConfig(tile_cap=tile_cap, chunk=chunk)
    cap = k3.walk_cap(chunk, tile_cap)
    assert cap == max(tile_cap // chunk, 1) * chunk
    args, cam, _ = _blend_inputs(arrs, CAM, cfg)
    capped = t3.blend3d_plain(*args)
    assert int(args[7].max()) > cap
    at_cap = t3.blend3d_plain(*args[:10], cap)
    for a, b in zip(capped, at_cap):
        assert torch.equal(a, b)
    jcfg = JRasterConfig(tile_cap=tile_cap, chunk=chunk, pair_cap=1 << 14,
                         use_pallas=False)
    bg = (0.1, 0.2, 0.3)
    j, _, _ = _both(arrs, CAM, jcfg, cfg, bg=bg)
    img, depth, alpha = _as_images(capped, cam, bg)
    np.testing.assert_allclose(img.numpy(), j[0], atol=2e-5)
    np.testing.assert_allclose(depth.numpy(), j[2], atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), j[3], atol=2e-5)
    full = t3.blend3d_plain(*args[:10], 1 << 12)
    assert float((full[0] - capped[0]).abs().max()) > 1e-3


def test_empty_view_renders_background_with_zero_gradients():
    """Every splat behind the camera: no pair.  Both packages render the
    background with alpha and depth 0; the JAX gradients and the plain
    VJP (the CPU route of K6's wrapper) are zero."""
    arrs = scene(24, seed=9)
    # behind the camera, on the far side of its centre from the origin
    centre = np.asarray(orbit_camera(**CAM, device="cpu").cam_center)
    arrs[0] = (1.5 * centre[None] + 0.1 * arrs[0]).astype(np.float32)
    bg = (0.1, 0.2, 0.3)
    j, t, _ = _both(arrs, CAM, bg=bg)
    _check_outputs(j, t)
    np.testing.assert_array_equal(t[0], np.broadcast_to(
        np.float32(bg), t[0].shape))
    assert not t[2].any() and not t[3].any() and not t[1].any()
    args, cam, xs = _blend_inputs(arrs, CAM, grad=True)
    assert int(args[7].sum()) == 0

    def jloss(*a):
        img, _, depth, alpha = j3.rasterize_3dgs(*a, jorbit(**CAM),
                                                 cfg=JCFG)
        return jnp.sum(jnp.concatenate([img, depth, alpha], -1))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    assert not any(np.asarray(g).any() for g in jg)
    nt = args[6].shape[0]
    cot = (torch.ones(nt, 256), torch.ones(nt, 256, 3), torch.ones(nt, 256))
    plain = [a.detach() if torch.is_tensor(a) else a for a in args[:9]]
    for g, x in zip(k3.blend3d_bwd(*plain, None, None, *cot), args[:5]):
        assert g.shape == x.shape and not g.any()
    # a backward through the empty render gives zeros (it raised before)
    img, radii, depth, alpha = t3.rasterize_3dgs(*xs, cam,
                                                 bg=torch.tensor(bg))
    assert torch.equal(img, torch.from_numpy(t[0]))
    grads = torch.autograd.grad(img.sum() + depth.sum() + alpha.sum(), xs,
                                allow_unused=True)
    assert all(g is None or not g.any() for g in grads)
    assert grads[3] is not None and grads[4] is not None


def _walk_before_split(arrs, kw, cfg, grad=False):
    """rasterize_3dgs's tile walk as it stood before blend3d_plain was
    split out of it (the same chunk ops, inline, differentiated by
    autograd), for the bitwise test; returns the state and the scene
    inputs (requiring a gradient with ``grad``)."""
    args, cam, xs = _blend_inputs(arrs, kw, cfg, grad)
    conic, center, colors, depth, opac, pair_gid, start, count, gx = \
        args[:9]
    num_tiles, k = start.shape[0], cfg.chunk
    pix_all = _tile_pixels(gx, torch.arange(num_tiles)) - 0.5
    n_walk = min(-(-int(count.max()) // k), max(cfg.tile_cap // k, 1))
    gid, start = pair_gid.long(), start.long()
    end = start + count.long()
    T_acc = torch.ones((num_tiles, 256))
    C_acc = torch.zeros((num_tiles, 256, colors.shape[-1]))
    D_acc = torch.zeros((num_tiles, 256))
    for ci in range(n_walk):
        tiles = torch.nonzero(count > ci * k)[:, 0]
        offs = start[tiles, None] + ci * k + torch.arange(k)[None]
        ok = offs < end[tiles, None]
        ids = gid[torch.clamp(offs, max=gid.shape[0] - 1)]
        op = torch.where(ok, opac[ids], 0.0)
        T1, C1, D1 = t3._blend_chunk(
            T_acc[tiles], C_acc[tiles], D_acc[tiles], pix_all[tiles],
            conic[ids], center[ids], colors[ids], depth[ids], op)
        T_acc = T_acc.index_copy(0, tiles, T1)
        C_acc = C_acc.index_copy(0, tiles, C1)
        D_acc = D_acc.index_copy(0, tiles, D1)
    return (T_acc, C_acc, D_acc), xs


@pytest.mark.parametrize("tile_cap, chunk", [(256, 64), (100, 32)])
def test_rasterize_3dgs_cpu_bitwise_as_before_the_split(tile_cap, chunk):
    """On the CPU, rasterize_3dgs (through Blend3D's CPU route: the plain
    walk forward, its autograd VJP backward) gives bitwise the images and
    the scene inputs' gradients of its inline walk before the split."""
    arrs = scene(200, seed=6, spread=0.3, size=0.1)
    cfg = RasterConfig(tile_cap=tile_cap, chunk=chunk)
    bg = (0.1, 0.2, 0.3)
    cam = orbit_camera(**CAM, device="cpu")
    w = T(np.random.RandomState(8).uniform(size=(32, 32, 5)).astype(
        np.float32))
    xs = [T(a).requires_grad_(True) for a in arrs]
    img, _, depth, alpha = t3.rasterize_3dgs(*xs, cam, bg=torch.tensor(bg),
                                             cfg=cfg)
    state, ref_xs = _walk_before_split(arrs, CAM, cfg, grad=True)
    ref = _as_images(state, cam, bg)
    for a, b in zip((img, depth, alpha), ref):
        assert torch.equal(a, b)
    grads = torch.autograd.grad(
        torch.sum(torch.cat([img, depth, alpha], -1) * w), xs)
    ref_grads = torch.autograd.grad(torch.sum(torch.cat(ref, -1) * w),
                                    ref_xs)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


def test_blend3d_wrappers_refuse_bad_inputs():
    """The kernels' argument checks (check_inputs) refuse a wrong dtype,
    shape, device or colour count, and the wrappers a device that is
    neither the CPU nor CUDA."""
    arrs = scene(40, seed=2)
    args, _, _ = _blend_inputs(arrs, CAM)
    ins = [a.detach().contiguous() for a in args[:8]]
    assert k3.check_inputs(*ins) == (40, 3)

    def refused(i, bad, exc=ValueError, match=None):
        with pytest.raises(exc, match=match):
            k3.check_inputs(*(bad if j == i else a
                              for j, a in enumerate(ins)))
    refused(0, ins[0].double(), TypeError, "float32")
    refused(5, ins[5].long(), TypeError, "int32")
    refused(1, ins[1][:, :1].contiguous(), match="do not fit")
    refused(3, ins[3][:-1], match="do not fit")
    refused(2, ins[2][:, :2].contiguous(), match="channels")
    refused(2, torch.cat([ins[2], ins[2][:, :1]], -1), match="channels")
    refused(1, ins[1].t().contiguous().t(), match="contiguous")
    refused(4, ins[4].to("meta"), match="expected cpu")
    refused(7, ins[7][:-1], match="differ")
    meta = [a.to("meta") for a in ins]
    with pytest.raises(ValueError, match="cpu or cuda"):
        k3.blend3d_fwd(*meta, 4)
    nt = ins[6].shape[0]
    with pytest.raises(ValueError, match="cpu or cuda"):
        k3.blend3d_bwd(*meta, 4, *(torch.zeros(nt, 256, device="meta"),) * 2,
                       *(torch.zeros(nt, 256, device="meta"),) * 3)
