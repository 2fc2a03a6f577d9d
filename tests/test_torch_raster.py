"""Port parity, rasterizer: binning (bitwise), the plain tiled blend and
the tiled/dense renderers of d2dgs_torch against d2dgs_tpu, with the
JAX side both on its XLA path and on the work-queue Pallas forward kernel
in interpret mode.  The CUDA kernel's own tests are in
tests/test_torch_cuda.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data import synthetic
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.binning import required_emission as jrequired
from d2dgs_tpu.ops.dense_raster import rasterize_dense as jdense
from d2dgs_tpu.ops.pallas.blend_tpu import blend_tiles_wq, build_work_queue
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_tpu.ops.tiled_raster import blend_tiles_xla
from d2dgs_tpu.ops.tiled_raster import rasterize_tiled as jtiled
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import Camera
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import blend_fwd
from d2dgs_torch.ops.dense_raster import rasterize_dense
from d2dgs_torch.ops.projection import Preprocessed
from d2dgs_torch.ops.tiled_raster import (ROW_N_BLEND, ROW_N_EVAL,
                                          blend_tiles_plain, pack_features,
                                          rasterize_tiled)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

IMG = dict(rtol=1e-5, atol=1e-5)      # image rows (colour, T)
AUX = dict(rtol=1e-4, atol=1e-5)      # allmap rows
CFG = RasterConfig()
# JAX caps: small so interpret mode walks few grid steps, large enough
# that nothing is dropped (asserted per scene)
JCFG = JRasterConfig(tile_cap=256, chunk=64, pair_cap=2048,
                     emission_cap=1 << 14)


def T(a):
    return torch.from_numpy(np.array(a))


def port_camera(cam) -> Camera:
    return Camera(w2c=T(cam.w2c), cam_center=T(cam.cam_center), fx=T(cam.fx),
                  fy=T(cam.fy), time=T(cam.time), H=cam.H, W=cam.W)


def _pallas_scene(opaque=False):
    """The shapes of tests/test_pallas_blend.py: 48x64, 160 splats."""
    n = 160
    rs = np.random.RandomState(0)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + 1.0)))
    if opaque:
        opac = np.full(n, 0.999)    # saturates T: early termination
    colors = rs.uniform(size=(n, 3))
    cam = synthetic.orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64)
    return cam, [np.asarray(a, np.float32)
                 for a in (means, scales, quats, opac, colors)]


def _low_opacity_scene():
    """tests/test_cull_invariance.py low_opacity_scene: opacities down to
    0.005 and large splats."""
    cam = synthetic.test_camera(H=64, W=64)
    means, scales, quats, _, colors = synthetic.random_gaussians(
        jax.random.PRNGKey(11), 120, scale_range=(0.05, 0.30))
    u = jax.random.uniform(jax.random.PRNGKey(12), (120,))
    opac = jnp.exp(jnp.log(0.005) + u * (jnp.log(1.0) - jnp.log(0.005)))
    return cam, [np.asarray(a) for a in (means, scales, quats, opac, colors)]


def _fat_scene():
    """tests/test_cull_invariance.py fat_scene: rects of many tiles."""
    cam = synthetic.test_camera(H=96, W=96)
    means, _, quats, opac, colors = synthetic.random_gaussians(
        jax.random.PRNGKey(3), 16)
    scales = jax.random.uniform(jax.random.PRNGKey(4), (16, 2),
                                minval=0.5, maxval=1.0)
    return cam, [np.asarray(a) for a in (means, scales, quats, opac, colors)]


SCENES = {"pallas": _pallas_scene,
          "opaque": functools.partial(_pallas_scene, True),
          "low_opacity": _low_opacity_scene, "fat": _fat_scene}


@functools.cache
def scene(name):
    return SCENES[name]()


@functools.cache
def jax_prep(name):
    cam, (means, scales, quats, opac, _) = scene(name)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), cam)
    return prep, jnp.where(prep.valid, jnp.asarray(opac), 0.0)


def port_prep(prep) -> Preprocessed:
    return Preprocessed(*(T(a) for a in prep))


@pytest.mark.parametrize("name,cull", [("pallas", True), ("opaque", True),
                                       ("low_opacity", True),
                                       ("low_opacity", False),
                                       ("fat", True)])
def test_binning_bitwise(name, cull):
    """Same Preprocessed in -> the same pair lists out, bit for bit."""
    cam, _ = scene(name)
    prep, opac = jax_prep(name)
    gx, gy = tile_grid(cam.H, cam.W)
    jcfg = dataclasses.replace(JCFG, tile_circle_cull=cull,
                               emission_cap=int(jrequired(prep)) + 64)
    jb = jbin(prep, gx, gy, jcfg, opacity=opac)
    tb = bin_gaussians(port_prep(prep), gx, gy,
                       RasterConfig(tile_circle_cull=cull), opacity=T(opac))
    n = int(jb.num_pairs)
    assert int(jb.clamped) == 0 and int(tb.clamped) == 0
    assert int(tb.num_pairs) == n and tb.pair_rank.shape == (n,)
    for f in ("order", "tile_start", "tile_count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.pair_rank.numpy(),
                                  np.asarray(jb.pair_rank)[:n])
    np.testing.assert_array_equal(tb.pair_gid.numpy(),
                                  np.asarray(jb.pair_gid)[:n])


def _xla_rows(st):
    """JAX BlendState [T, P] fields -> rows [T, 14, P] (ROW_* layout)."""
    return np.stack([st.T, st.done.astype(np.float32), st.dist1, st.dist2,
                     *np.moveaxis(np.asarray(st.color), -1, 0), st.depth,
                     *np.moveaxis(np.asarray(st.normal), -1, 0),
                     st.distortion, st.med_depth, st.med_weight], axis=1)


def _compare_rows(port, ref, what):
    """State rows 0-13: T and colour at the image tolerance, the rest at
    the allmap tolerance."""
    port = port[:, :14].numpy()
    img = [0, 1, 4, 5, 6]
    np.testing.assert_allclose(port[:, img], ref[:, img], **IMG, err_msg=what)
    aux = [r for r in range(14) if r not in img]
    np.testing.assert_allclose(port[:, aux], ref[:, aux], **AUX, err_msg=what)


@pytest.mark.parametrize("name", ["pallas", "opaque"])
def test_blend_tiles_plain_matches_jax_states(name):
    """blend_tiles_plain vs the JAX XLA tile blend and vs K1
    (_fwd_wq_kernel, interpret mode) on identical features and pairs."""
    cam, (*_, colors) = scene(name)
    prep, opac = jax_prep(name)
    gx, gy = tile_grid(cam.H, cam.W)
    jb = jbin(prep, gx, gy, JCFG, opacity=opac)
    assert int(jb.clamped) == 0 and int(jb.tile_count.max()) <= JCFG.tile_cap
    num_tiles = gx * gy
    feats = jnp.concatenate([prep.T.reshape(-1, 9), prep.center, prep.normal,
                             jnp.asarray(colors), opac[:, None]], axis=-1)
    gdata, wt, first, last, overflow = build_work_queue(feats, jb, num_tiles,
                                                        JCFG)
    assert int(overflow) == 0
    k1 = np.asarray(blend_tiles_wq(gdata, wt, wt, first, last, num_tiles, gx,
                                   JCFG.pair_cap // JCFG.chunk))
    *_, xla_state = blend_tiles_xla(prep.T, prep.center, prep.normal,
                                    jnp.asarray(colors), opac, None, jb,
                                    gx, gy, JCFG)
    xla = _xla_rows(jax.tree.map(np.asarray, xla_state))

    tp = port_prep(prep)
    tb = bin_gaussians(tp, gx, gy, CFG, opacity=T(opac))
    tf = pack_features(tp.T, tp.center, tp.normal, T(colors), T(opac))
    fs = tf[tb.order.long()]
    port = blend_tiles_plain(fs, tb.pair_rank, tb.tile_start, tb.tile_count,
                             gx, chunk=CFG.chunk)
    _compare_rows(port, k1[:, :14], "vs K1 interpret")
    _compare_rows(port, xla, "vs XLA blend")
    if name == "opaque":
        assert port[:, 1].sum() > 0, "scene must drive early termination"
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = blend_fwd.launches
    np.testing.assert_array_equal(
        blend_fwd(fs, tb.pair_rank, tb.tile_start, tb.tile_count,
                  gx).numpy(), port.numpy())
    assert blend_fwd.launches == before
    # work counters: every blended pair was evaluated, and no pixel
    # evaluates more pairs than its tile holds
    n_eval, n_blend = port[:, ROW_N_EVAL], port[:, ROW_N_BLEND]
    assert bool((n_blend <= n_eval).all())
    assert bool((n_eval <= tb.tile_count[:, None].float()).all())


@pytest.mark.parametrize("name", ["pallas", "opaque"])
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "k1"])
def test_rasterize_tiled_parity(name, pallas):
    cam, arrs = scene(name)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    jcfg = dataclasses.replace(JCFG, use_pallas=pallas,
                               pallas_interpret=pallas, use_workqueue=True)
    jc, ja, jr, _, jb = jtiled(*map(jnp.asarray, arrs), cam,
                               jnp.asarray(bg), cfg=jcfg)
    tc, ta, tr, _, tb = rasterize_tiled(*map(T, arrs), port_camera(cam),
                                        T(bg), cfg=CFG)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **IMG)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **AUX)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tb.num_pairs) == int(jb.num_pairs)


@pytest.mark.parametrize("name", ["low_opacity", "fat"])
def test_dense_parity_and_tiled_vs_dense(name):
    cam, arrs = scene(name)
    bg = np.array([0.3, 0.3, 0.3], np.float32)
    jc, ja, jr, _ = jdense(*map(jnp.asarray, arrs), cam, jnp.asarray(bg))
    tc, ta, tr, _ = rasterize_dense(*map(T, arrs), port_camera(cam), T(bg))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **IMG)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **AUX)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # the port's tiled renderer against its own dense oracle
    c2, a2, *_ = rasterize_tiled(*map(T, arrs), port_camera(cam), T(bg))
    np.testing.assert_allclose(c2.numpy(), tc.numpy(), **IMG)
    np.testing.assert_allclose(a2.numpy(), ta.numpy(), rtol=1e-4, atol=1e-4)
