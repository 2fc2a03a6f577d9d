"""Port parity, the dense blend route (``use_workqueue=False``): the pair
buffer ``build_gdata``, the plain versions of K3 and K4 against the JAX
package's dense Pallas kernels (``_fwd_kernel``/``_bwd_kernel``, in
interpret mode), the whole tiled render on that route, and the per-tile
``tile_cap`` truncation with its ``overflow`` count on both routes.

Tolerances are those the JAX package holds its own kernels to
(tests/test_pallas_blend.py): image rows rtol/atol 1e-5, the other rows
rtol 1e-4 atol 1e-5, gradients max-normalised rtol 2e-4 atol 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.pallas.blend_tpu import blend_tiles_pallas
from d2dgs_tpu.ops.pallas.blend_tpu import build_gdata as jbuild_gdata
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_tpu.ops.tiled_raster import blend_tiles as jblend_tiles
from d2dgs_tpu.ops.tiled_raster import rasterize_tiled as jtiled
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops.binning import Binning
from d2dgs_torch.ops.cuda.blend import DEAD_ROWS
from d2dgs_torch.ops.cuda.blend_dense import (BlendTilesDense,
                                              blend_dense_bwd,
                                              blend_dense_fwd,
                                              blend_dense_plain,
                                              blend_dense_plain_vjp,
                                              build_gdata)
from d2dgs_torch.ops.tiled_raster import (NFEAT, blend_tiles,
                                          rasterize_tiled)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

H, W = 48, 64
IMG = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
IMG_ROWS = [0, 1, 4, 5, 6]                  # T, done, colour
AUX_ROWS = [2, 3, 7, 8, 9, 10, 11, 12, 13]  # the other rows the TPU keeps


def T(a):
    return torch.from_numpy(np.array(a))


def _scene(kind):
    """48x64 views: the 160 splats of tests/test_pallas_blend.py
    ("pallas"), the same all at opacity 0.999 ("opaque"), and 300 splats
    packed near the view centre ("packed": its busiest tiles hold ~270
    pairs, above a tile_cap of 128)."""
    return list(blend_test_scene(kind, n_packed=300))


def _jcfg(tile_cap, use_workqueue=False):
    return JRasterConfig(tile_cap=tile_cap, chunk=64, pair_cap=4096,
                         emission_cap=1 << 14, use_pallas=True,
                         pallas_interpret=True, use_workqueue=use_workqueue)


def _jax_pairs(kind):
    """The JAX side's preprocessed splats, binning and features."""
    means, scales, quats, opac, colors = _scene(kind)
    cam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)
    gx, gy = tile_grid(H, W)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), cam)
    op = jnp.where(prep.valid, jnp.asarray(opac), 0.0)
    jb = jbin(prep, gx, gy, _jcfg(256), opacity=op)
    n = means.shape[0]
    feats = jnp.concatenate([prep.T.reshape(n, 9), prep.center, prep.normal,
                             jnp.asarray(colors), op[:, None]], axis=-1)
    return prep, op, jb, feats, gx


def _port_binning(jb) -> Binning:
    return Binning(order=T(jb.order), pair_rank=T(jb.pair_rank),
                   tile_start=T(jb.tile_start), tile_count=T(jb.tile_count),
                   num_pairs=T(jb.num_pairs), clamped=T(jb.clamped))


@pytest.mark.parametrize("tile_cap", [128, 256])
@pytest.mark.parametrize("kind", ["pallas", "packed"])
def test_build_gdata_bitwise(kind, tile_cap):
    """(e) The dense pair buffer and its counts equal JAX's bit for bit,
    from the same features and binning (including truncated tiles)."""
    _, _, jb, feats, gx = _jax_pairs(kind)
    jg, jc = jbuild_gdata(feats, jb, jb.tile_start.shape[0],
                          _jcfg(tile_cap))
    tg, tc = build_gdata(T(feats), _port_binning(jb), tile_cap)
    assert tg.shape == (jb.tile_start.shape[0], tile_cap, NFEAT)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32
    if kind == "packed" and tile_cap == 128:
        assert int(jb.tile_count.max()) > tile_cap


@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_dense_plain_matches_jax_k3(kind):
    """(a) blend_dense_plain against JAX blend_tiles_pallas (K3 in
    interpret mode) on the same gdata and counts: state rows 0-13."""
    _, _, jb, feats, gx = _jax_pairs(kind)
    num_tiles = jb.tile_start.shape[0]
    gdata, counts = jbuild_gdata(feats, jb, num_tiles, _jcfg(256))
    ref = np.asarray(blend_tiles_pallas(gdata, counts, num_tiles, gx, 2))
    out = blend_dense_plain(T(gdata), T(counts), gx).numpy()
    np.testing.assert_allclose(out[:, IMG_ROWS], ref[:, IMG_ROWS], **IMG)
    np.testing.assert_allclose(out[:, AUX_ROWS], ref[:, AUX_ROWS], **AUX)
    if kind == "opaque":
        assert out[:, 1].sum() > 0, "no early termination"
    # the CPU wrapper is the plain version and launches nothing
    before = blend_dense_fwd.launches
    wrapped = blend_dense_fwd(T(gdata), T(counts), gx,
                              max_pairs=jb.pair_rank.shape[0])
    assert blend_dense_fwd.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), out)


@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_dense_plain_vjp_matches_jax_k4(kind):
    """(b) blend_dense_plain_vjp against the VJP of blend_tiles_pallas (K4
    in interpret mode) under a seeded cotangent with the dead rows zeroed,
    max-normalised over the whole array as tests/test_pallas_blend.py
    normalises its gradients."""
    _, _, jb, feats, gx = _jax_pairs(kind)
    num_tiles = jb.tile_start.shape[0]
    gdata, counts = jbuild_gdata(feats, jb, num_tiles, _jcfg(256))
    g = np.random.RandomState(5).normal(size=(num_tiles, 16, 256))
    g = g.astype(np.float32)
    g[:, list(DEAD_ROWS)] = 0.0
    _, vjp = jax.vjp(lambda x: blend_tiles_pallas(x, counts, num_tiles, gx,
                                                  2), gdata)
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    out = blend_dense_plain_vjp(T(gdata), T(counts), gx, T(g)).numpy()
    assert (np.abs(ref).reshape(-1, NFEAT).max(axis=0) > 0).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, **GRAD)
    # past each tile's count the gradient is zero, as the TPU kernel's
    past = np.arange(256)[None, :] >= np.asarray(counts)[:, None]
    assert not np.abs(out[past]).any()
    # the CPU wrappers: the backward wrapper is the plain VJP, and the
    # autograd function pairs the plain forward with it
    before = blend_dense_bwd.launches
    f = T(gdata).requires_grad_()
    state = BlendTilesDense.apply(f, T(counts), gx, jb.pair_rank.shape[0])
    d_fn, = torch.autograd.grad(state, f, T(g))
    assert blend_dense_bwd.launches == before
    torch.testing.assert_close(d_fn, T(out), rtol=0, atol=0)
    # a tile subset gives the gradient of those tiles alone
    tiles = torch.tensor([1, 5, 6])
    keep = torch.zeros(num_tiles, dtype=torch.bool)
    keep[tiles] = True
    d_sub = blend_dense_plain_vjp(T(gdata), T(counts), gx, T(g), tiles=tiles)
    d_full = blend_dense_plain_vjp(T(gdata), T(counts), gx, torch.where(
        keep[:, None, None], T(g), 0.0))
    torch.testing.assert_close(d_sub, d_full, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pallas_scene():
    return _scene("pallas")


def test_rasterize_tiled_dense_route_forward(pallas_scene):
    """(c) The whole tiled render on the dense route, against JAX's with
    K3 in interpret mode."""
    means, scales, quats, opac, colors = pallas_scene
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    jcam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)
    cj, aj, *_ = jtiled(*map(jnp.asarray, pallas_scene), jcam,
                        jnp.asarray(bg), cfg=_jcfg(256))
    tcam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device="cpu")
    cfg = RasterConfig(use_workqueue=False, tile_cap=256)
    ct, at, *_ = rasterize_tiled(*map(T, pallas_scene), tcam, T(bg),
                                 cfg=cfg)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **IMG)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **AUX)
    # the two routes of the port agree
    cw, aw, *_ = rasterize_tiled(*map(T, pallas_scene), tcam, T(bg),
                                 cfg=RasterConfig(tile_cap=256))
    torch.testing.assert_close(ct, cw, **IMG)
    torch.testing.assert_close(at, aw, **AUX)


def test_rasterize_tiled_dense_route_gradients(pallas_scene):
    """(c) Gradients in means, scales, quats, opacity and colours through
    the dense route, against JAX's K3/K4 in interpret mode, with a loss on
    the image and every allmap channel (tests/test_pallas_blend.py)."""
    tgt = np.linspace(0, 1, H * W * 3, dtype=np.float32).reshape(H, W, 3)
    wch = np.array([1.0, 0.5, 0.3, 0.3, 0.3, 0.7, 0.2, 0.1], np.float32)
    jcam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)

    def jloss(params):
        color, allmap, *_ = jtiled(*params, jcam, jnp.zeros(3),
                                   cfg=_jcfg(256))
        return (jnp.sum((color - tgt) ** 2)
                + jnp.sum(allmap * wch) * 1e-2)

    jg = jax.grad(jloss)(tuple(map(jnp.asarray, pallas_scene)))
    tcam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device="cpu")
    params = [T(a).requires_grad_() for a in pallas_scene]
    color, allmap, *_ = rasterize_tiled(
        *params, tcam, torch.zeros(3),
        cfg=RasterConfig(use_workqueue=False, tile_cap=256))
    loss = torch.sum((color - T(tgt)) ** 2) + torch.sum(allmap * T(wch)) \
        * 1e-2
    tg = torch.autograd.grad(loss, params)
    for a, b, name in zip(tg, jg, "msqoc"):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, b / scale, **GRAD,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("use_workqueue", [True, False], ids=["wq", "dense"])
def test_tile_cap_truncation_and_overflow(use_workqueue):
    """(d) A view whose busiest tiles hold more pairs than tile_cap: both
    packages blend each tile's tile_cap nearest pairs and report the rest
    as overflow.  Without the cap (the port before it had one) the image
    differs from the JAX package's by far more than the tolerance."""
    scene = _scene("packed")
    cap = 128
    jcam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=H, W=W)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    jcfg = _jcfg(cap, use_workqueue)
    cj, aj, _, jprep, jb = jtiled(*map(jnp.asarray, scene), jcam,
                                  jnp.asarray(bg), cfg=jcfg)
    assert int(jb.tile_count.max()) > cap
    gx, gy = tile_grid(H, W)
    op = jnp.where(jprep.valid, jnp.asarray(scene[3]), 0.0)
    j_overflow = int(jblend_tiles(jprep.T, jprep.center, jprep.normal,
                                  jnp.asarray(scene[4]), op, jb, gx, gy,
                                  jcfg)[2])
    assert j_overflow == int(np.maximum(np.asarray(jb.tile_count) - cap,
                                        0).sum()) > 0

    tcam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device="cpu")
    cfg = RasterConfig(tile_cap=cap, use_workqueue=use_workqueue)
    ct, at, _, tprep, tb = rasterize_tiled(*map(T, scene), tcam, T(bg),
                                           cfg=cfg)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **IMG)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **AUX)
    t_opac = torch.where(tprep.valid, T(scene[3]), 0.0)
    _, _, t_overflow = blend_tiles(tprep.T, tprep.center, tprep.normal,
                                   T(scene[4]), t_opac, tb, gx, gy, cfg)
    assert t_overflow.dtype == torch.int32
    assert int(t_overflow) == j_overflow
    # the fault: blending every pair renders another image
    full, *_ = rasterize_tiled(*map(T, scene), tcam, T(bg),
                               cfg=RasterConfig(use_workqueue=use_workqueue))
    assert float((full - ct).abs().max()) > 0.1
    _, _, none = blend_tiles(tprep.T, tprep.center, tprep.normal,
                             T(scene[4]), t_opac, tb, gx, gy, RasterConfig())
    assert int(none) == 0
