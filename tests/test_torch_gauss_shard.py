"""Port parity, the sharded render (d2dgs_torch/parallel/gauss_shard.py):
the Gaussians and the interleaved tiles sharded over 2 and 4 gloo ranks
(spawned processes, tests/torch_parallel_workers.py) against the JAX
``render_gauss_sharded`` over 2 and 4 virtual devices and against the
port's unsharded ``rasterize_tiled``: the image, the allmap, the
gradients in means and opacity, the exchange's record counts and its
overflow at a cap of 2.  Tolerances are tests/test_gauss_shard.py's.
Also the plain slab blend with the global-tile map against the
whole-grid blend of the same tiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parallel_workers import SCENE_KEYS, camera_arrays, render_ranks

from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import (DEAD_ROWS, blend_fwd,
                                        blend_tiles_plain_vjp)
from d2dgs_torch.ops.projection import preprocess, tile_grid
from d2dgs_torch.ops.tiled_raster import (blend_tiles_plain, pack_features,
                                          rasterize_tiled)
from d2dgs_torch.parallel.gauss_shard import pad_to_multiple
from d2dgs_torch.parallel.multihost import run_local
from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.parallel.gauss_shard import AXIS
from d2dgs_tpu.parallel.gauss_shard import \
    measure_exchange_counts as jmeasure
from d2dgs_tpu.parallel.gauss_shard import \
    render_gauss_sharded as jrender_sharded

torch.set_num_threads(1)

CFG = RasterConfig(tile_cap=256, chunk=64)
JCFG = JRasterConfig(tile_cap=256, chunk=64, use_pallas=False)
CAM = dict(azimuth=0.4, elevation=0.2, radius=4.0, fov=0.8, H=48, W=48)
BG = np.array([0.2, 0.1, 0.4], np.float32)
IMAGE = dict(atol=3e-5, rtol=0)
ALLMAP = dict(atol=3e-4, rtol=0)
GRADS = dict(atol=1e-5, rtol=1e-3)


def _scene(n=64):
    rs = np.random.RandomState(7)
    q = rs.normal(size=(n, 4)).astype(np.float32)
    return dict(
        means=(rs.normal(size=(n, 3)) * 0.6).astype(np.float32),
        scales=(np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.1).astype(
            np.float32),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacity=rs.uniform(0.3, 0.9, size=n).astype(np.float32),
        colors=rs.uniform(size=(n, 3)).astype(np.float32),
        alive=np.arange(n) < n - 4)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def port_runs(scene, tmp_path_factory):
    """The port's sharded render at D = 2 and 4 ranks."""
    tmp = tmp_path_factory.mktemp("gauss_shard")
    inp = str(tmp / "scene.npz")
    cam = orbit_camera(**CAM, device="cpu")
    np.savez(inp, bg=BG, **scene, **camera_arrays(cam))
    runs = {}
    for D in (2, 4):
        out = str(tmp / f"out{D}.pt")
        run_local(render_ranks, D, inp, out, store=str(tmp / f"store{D}"))
        runs[D] = torch.load(out, weights_only=False)
    return runs


def _jax_loss(mesh, cam, scene, m, o):
    out = jrender_sharded(mesh, cam, m, jnp.asarray(scene["scales"]),
                          jnp.asarray(scene["quats"]), o,
                          jnp.asarray(scene["colors"]),
                          jnp.asarray(scene["alive"]), bg=jnp.asarray(BG),
                          cfg=JCFG)
    return jnp.mean((out.image - 0.5) ** 2)


@pytest.fixture(scope="module")
def unsharded(scene):
    """The port's whole-grid render and its gradients."""
    t = {k: torch.tensor(v) for k, v in scene.items()}
    m, o = t["means"].requires_grad_(), t["opacity"].requires_grad_()
    img, allmap, *_ = rasterize_tiled(
        m, t["scales"], t["quats"], torch.where(t["alive"], o, 0.0),
        t["colors"], orbit_camera(**CAM, device="cpu"), bg=torch.tensor(BG),
        cfg=CFG)
    gm, go = torch.autograd.grad(torch.mean((img - 0.5) ** 2), [m, o])
    return img.detach(), allmap.detach(), gm, go


@pytest.mark.parametrize("D", [2, 4])
def test_forward_and_gradients_match_jax_and_unsharded(scene, port_runs,
                                                       unsharded, D):
    r = port_runs[D]
    mesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    jcam = jorbit(**CAM)
    a = {k: jnp.asarray(v) for k, v in scene.items()}
    jout = jax.jit(lambda *x: jrender_sharded(
        mesh, jcam, *x, bg=jnp.asarray(BG), cfg=JCFG))(
        *(a[k] for k in SCENE_KEYS))
    assert int(jout.overflow) == 0 == r["overflow"]
    np.testing.assert_allclose(r["image"].numpy(), np.asarray(jout.image),
                               **IMAGE)
    np.testing.assert_allclose(r["allmap"].numpy(), np.asarray(jout.allmap),
                               **ALLMAP)
    img, allmap, gm, go = unsharded
    np.testing.assert_allclose(r["image"].numpy(), img.numpy(), **IMAGE)
    np.testing.assert_allclose(r["allmap"].numpy(), allmap.numpy(),
                               **ALLMAP)

    jg = jax.jit(jax.grad(lambda m, o: _jax_loss(mesh, jcam, scene, m, o),
                          argnums=(0, 1)))(a["means"], a["opacity"])
    for port, ref, whole in ((r["d_means"], jg[0], gm),
                             (r["d_opacity"], jg[1], go)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **GRADS)
        np.testing.assert_allclose(port.numpy(), whole.numpy(), **GRADS)


@pytest.mark.parametrize("D", [2, 4])
def test_exchange_counts_match_jax(scene, port_runs, D):
    """The per-(source, destination) record counts, exactly."""
    mesh = Mesh(np.array(jax.devices()[:D]), (AXIS,))
    a = {k: jnp.asarray(v) for k, v in scene.items()}
    jmat = jmeasure(mesh, jorbit(**CAM), a["means"], a["scales"],
                    a["quats"], a["alive"], JCFG, opacity=a["opacity"],
                    full=True)
    np.testing.assert_array_equal(port_runs[D]["counts"], jmat)


@pytest.mark.parametrize("D", [2, 4])
def test_overflow_reported(port_runs, D):
    """A cap of 2 records per rank pair drops records and says how many:
    the counts past the cap, summed."""
    r = port_runs[D]
    want = int(np.maximum(r["counts"] - 2, 0).sum())
    assert r["overflow_cap2"] == want > 0


def test_overflow_matches_jax(scene, port_runs):
    mesh = Mesh(np.array(jax.devices()[:4]), (AXIS,))
    a = {k: jnp.asarray(v) for k, v in scene.items()}
    out = jax.jit(lambda *x: jrender_sharded(
        mesh, jorbit(**CAM), *x, bg=jnp.zeros(3), cfg=JCFG,
        exchange_cap=2))(*(a[k] for k in SCENE_KEYS))
    assert int(out.overflow) == port_runs[4]["overflow_cap2"] > 0


@pytest.mark.parametrize("D", [2, 3, 4])
def test_plain_slab_blend_with_global_tile_map(scene, D):
    """Every D-th tile blended as a slab, slot s at grid tile gtile[s],
    equals the whole-grid blend of those tiles bitwise, forward and VJP,
    through blend_tiles_plain, blend_fwd and blend_tiles_plain_vjp."""
    t = {k: torch.tensor(v) for k, v in scene.items()}
    cam = orbit_camera(**CAM, device="cpu")
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(t["means"], t["scales"], t["quats"], cam)
    prep = prep._replace(valid=prep.valid & t["alive"])
    opac = torch.where(prep.valid, t["opacity"], 0.0)
    b = bin_gaussians(prep, gx, gy, CFG, opacity=opac)
    fs = pack_features(prep.T, prep.center, prep.normal, t["colors"],
                       opac)[b.order.long()].contiguous()
    whole = blend_tiles_plain(fs, b.pair_rank, b.tile_start, b.tile_count,
                              gx)
    g = torch.tensor(np.random.RandomState(3).normal(
        size=whole.shape).astype(np.float32))
    g[:, list(DEAD_ROWS)] = 0.0
    d_whole = blend_tiles_plain_vjp(fs, b.pair_rank, b.tile_start,
                                    b.tile_count, gx, g)
    for d in range(D):
        gtile = torch.arange(d, gx * gy, D, dtype=torch.int32)
        sl = gtile.long()
        args = (fs, b.pair_rank, b.tile_start[sl], b.tile_count[sl], gx)
        slab = blend_tiles_plain(*args, tile_ids=gtile)
        assert torch.equal(slab, whole[sl])
        assert torch.equal(blend_fwd(*args, gtile=gtile), whole[sl])
        # the whole grid's VJP with the cotangent on this slab alone
        g_slab = torch.zeros_like(g)
        g_slab[sl] = g[sl]
        ref = blend_tiles_plain_vjp(fs, b.pair_rank, b.tile_start,
                                    b.tile_count, gx, g_slab)
        got = blend_tiles_plain_vjp(*args, g[sl], gtile=gtile)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(d_whole.abs().max()) > 0


def test_pad_to_multiple():
    a = np.ones((10, 3))
    p = pad_to_multiple(a, 8)
    assert p.shape == (16, 3) and p[10:].sum() == 0
    assert pad_to_multiple(a, 5) is a
