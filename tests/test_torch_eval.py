"""Port parity, eval: MS-SSIM, LPIPS (the random substitute and an npz of
weights the test writes), evaluate_image_metrics, render_test_set,
render_trajectory, the trajectory cameras and the mesh metrics,
d2dgs_torch against d2dgs_tpu on the same numpy inputs.

Tolerances: the metrics are float32 reductions of the same images, held
to rtol 1e-5 (PSNR/SSIM/MS-SSIM) and 1e-4 (LPIPS, sums over 512-channel
VGG maps); the renders of render_test_set differ by the two blends'
rounding (images to 1e-5), so their metrics are held to rtol 1e-4."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.eval import mesh_metrics as jmm
from d2dgs_tpu.eval import metrics as jmetrics
from d2dgs_tpu.eval import render_sets as jrs
from d2dgs_tpu.eval import trajectories as jtraj
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.eval import mesh_metrics as tmm
from d2dgs_torch.eval import metrics as tmetrics
from d2dgs_torch.eval import render_sets as trs
from d2dgs_torch.eval import trajectories as ttraj
from d2dgs_torch.io.from_jax import from_jax_arrays
from d2dgs_torch.train.config import TrainConfig

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

METRIC = dict(rtol=1e-5, atol=1e-6)
LPIPS = dict(rtol=1e-4, atol=1e-7)


def _pair(H=48, W=64, seed=0):
    """A smooth image and a noisy copy, in [0, 1]."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W] / 16.0
    a = np.stack([0.5 + 0.4 * np.sin(x + c) * np.cos(y - c)
                  for c in (0.0, 1.0, 2.0)], -1)
    b = np.clip(a + 0.08 * rs.randn(H, W, 3), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("shape", [(48, 64), (37, 61)])
def test_msssim_matches_jax(shape):
    a, b = _pair(*shape)
    j = float(jmetrics.msssim(jnp.asarray(a), jnp.asarray(b)))
    t = float(tmetrics.msssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(t, j, **METRIC)
    np.testing.assert_allclose(
        tmetrics._avg_pool2(torch.from_numpy(a)).numpy(),
        np.asarray(jmetrics._avg_pool2(jnp.asarray(a))), rtol=1e-6)


def test_lpips_rand_matches_jax():
    a, b = _pair()
    j = float(jmetrics.get_lpips_rand()(jnp.asarray(a), jnp.asarray(b)))
    t = float(tmetrics.get_lpips_rand()(torch.from_numpy(a),
                                        torch.from_numpy(b)))
    assert j > 0
    np.testing.assert_allclose(t, j, **LPIPS)
    assert float(tmetrics.get_lpips_rand()(torch.from_numpy(a),
                                           torch.from_numpy(a))) < 1e-6


def _weights_npz(tmp_path, seed=0):
    """An npz in the LPIPS-VGG loader's layout with random weights."""
    ch = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
          (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
          (512, 512), (512, 512)]
    rng = np.random.RandomState(seed)
    z = {}
    for i, (cin, cout) in enumerate(ch):
        z[f"conv{i}_w"] = rng.randn(cout, cin, 3, 3).astype(np.float32) * .05
        z[f"conv{i}_b"] = rng.randn(cout).astype(np.float32) * .01
    for j, t in enumerate((64, 128, 256, 512, 512)):
        z[f"lin{j}_w"] = rng.rand(t).astype(np.float32)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **z)
    return path


def test_evaluate_image_metrics_matches_jax(tmp_path):
    a, b = _pair(seed=3)
    path = _weights_npz(tmp_path)
    j = jmetrics.evaluate_image_metrics(jnp.asarray(a), jnp.asarray(b),
                                        lpips_weights=path)
    t = tmetrics.evaluate_image_metrics(torch.from_numpy(a), b,
                                        lpips_weights=path)
    assert set(t) == set(j) == {"psnr", "ssim", "ms_ssim", "lpips_vgg",
                                "lpips_rand"}
    for k in ("psnr", "ssim", "ms_ssim"):
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **METRIC)
    for k in ("lpips_vgg", "lpips_rand"):
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **LPIPS)
    # no weights: no lpips_vgg, never the substitute under its name
    assert "lpips_vgg" not in tmetrics.evaluate_image_metrics(
        torch.from_numpy(a), b)


# ----------------------------------------------------------------------
# renders of a split and trajectories
# ----------------------------------------------------------------------

CFG = dict(sh_degree=1, hyper_dim=2, node_num=16, gaussian_capacity=256,
           node_gauss_capacity=64)
CAMS = [dict(azimuth=a, elevation=0.2, radius=2.5, fov=0.9, H=32, W=40,
             time=t) for a, t in ((0.3, 0.0), (2.0, 0.5), (4.1, 1.0))]


@pytest.fixture(scope="module")
def scene():
    """A JAX TrainState of 128 opaque splats and 16 nodes, and the port's
    Gaussians and nodes carried across."""
    import dataclasses

    rs = np.random.RandomState(2)
    pts = (rs.randn(128, 3) * 0.4).astype(np.float32)
    cols = rs.rand(128, 3).astype(np.float32)
    jcfg = JTrainConfig(**CFG, raster=JRasterConfig(tile_cap=256, chunk=64))
    js = jtrainer.init_train_state(jax.random.PRNGKey(1), jcfg, pts, cols)
    g = js.gauss
    js = js._replace(gauss=dataclasses.replace(
        g, opacity=jnp.where(g.alive[:, None], 2.0, g.opacity),
        scaling=g.scaling + 0.7))
    leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(js)[0]}
    tg, tn = from_jax_arrays(leaves, device="cpu")
    tcfg = TrainConfig(**CFG, raster=RasterConfig(tile_cap=256, chunk=64))
    return jcfg, js, tcfg, tg, tn


def test_render_test_set_matches_jax(scene, tmp_path):
    jcfg, js, tcfg, tg, tn = scene
    gts = [np.random.RandomState(i).rand(32, 40, 3).astype(np.float32) * 0.3
           for i in range(len(CAMS))]
    jres = jrs.render_test_set(
        [(jorbit(**c), g) for c, g in zip(CAMS, gts)], js.gauss, js.nodes,
        jcfg.node_cfg, jcfg.raster, out_dir=str(tmp_path / "j"))
    tres = trs.render_test_set(
        [(orbit_camera(**c, device="cpu"), g) for c, g in zip(CAMS, gts)],
        tg, tn, tcfg.node_cfg, tcfg.raster, out_dir=str(tmp_path / "t"),
        return_images=2)
    assert len(tres["per_view"]) == len(CAMS)
    for tv, jv in zip(tres["per_view"], jres["per_view"]):
        assert tv.keys() == jv.keys() and tv["view"] == jv["view"]
        for k in ("psnr", "ssim", "ms_ssim", "lpips_rand"):
            np.testing.assert_allclose(tv[k], jv[k], rtol=1e-4, err_msg=k)
    assert tres["mean"].keys() == jres["mean"].keys()
    assert len(tres["images"]) == 2
    for (ri, gi), g in zip(tres["images"], gts):
        np.testing.assert_array_equal(gi, (g * 255).astype(np.uint8))
        assert ri.shape == (32, 40, 3) and ri.dtype == np.uint8
    for sub in ("renders", "gt", "depth"):
        assert sorted(p.name for p in (tmp_path / "t" / sub).iterdir()) == \
            sorted(p.name for p in (tmp_path / "j" / sub).iterdir())
    with open(tmp_path / "t" / "results.json") as fh:
        assert json.load(fh)["mean"] == tres["mean"]


def test_render_trajectory_matches_jax(scene, tmp_path):
    jcfg, js, tcfg, tg, tn = scene
    jf = jtraj.render_trajectory(
        jtraj.time_sweep_cameras(jorbit(**CAMS[0]), 3), js.gauss, js.nodes,
        jcfg.node_cfg, jcfg.raster, out_dir=str(tmp_path / "j"))
    tf = ttraj.render_trajectory(
        ttraj.time_sweep_cameras(orbit_camera(**CAMS[0], device="cpu"), 3),
        tg, tn, tcfg.node_cfg, tcfg.raster, out_dir=str(tmp_path / "t"))
    assert len(tf) == len(jf) == 3
    for t, j in zip(tf, jf):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    assert (tmp_path / "t" / "video.gif").exists()
    assert (tmp_path / "t" / "00002.png").exists()


@pytest.mark.parametrize("times", [None, "sweep", [0.1, 0.7, 0.3]])
def test_trajectory_cameras_match_jax(times):
    jc = jtraj.ellipse_path(3, 3.0, 0.2, 0.8, 16, 24, z_variation=0.1,
                            times=times, target=(0.1, 0.0, -0.2))
    tc = ttraj.ellipse_path(3, 3.0, 0.2, 0.8, 16, 24, z_variation=0.1,
                            times=times, target=(0.1, 0.0, -0.2),
                            device="cpu")
    sweep_j = jtraj.time_sweep_cameras(jc[1], 4)
    sweep_t = ttraj.time_sweep_cameras(tc[1], 4)
    for t, j in list(zip(tc, jc)) + list(zip(sweep_t, sweep_j)):
        for f in ("w2c", "cam_center", "fx", "fy", "time"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        assert (t.H, t.W) == (j.H, j.W)


# ----------------------------------------------------------------------
# mesh metrics
# ----------------------------------------------------------------------

def test_mesh_image_metrics_match_jax(tmp_path):
    from PIL import Image
    (tmp_path / "r").mkdir()
    (tmp_path / "g").mkdir()
    for i in range(2):
        a, b = _pair(seed=i)
        Image.fromarray((a * 255).astype(np.uint8)).save(
            tmp_path / "r" / f"{i}.png")
        Image.fromarray((b * 255).astype(np.uint8)).save(
            tmp_path / "g" / f"{i:05d}.png")
    j = jmm.mesh_image_metrics(str(tmp_path / "r"), str(tmp_path / "g"),
                               str(tmp_path / "jo"))
    t = tmm.mesh_image_metrics(str(tmp_path / "r"), str(tmp_path / "g"),
                               str(tmp_path / "to"), device="cpu")
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    assert (tmp_path / "to" / "mesh_render_results.json").exists()


def test_chamfer_matches_jax():
    rs = np.random.RandomState(0)
    v = rs.randn(30, 3).astype(np.float32)
    f = rs.randint(0, 30, size=(40, 3)).astype(np.int32)
    v2 = v + 0.01 * rs.randn(30, 3).astype(np.float32)
    pa = tmm.sample_mesh_surface(v, f, 500, seed=3)
    np.testing.assert_array_equal(pa, jmm.sample_mesh_surface(v, f, 500,
                                                              seed=3))
    np.testing.assert_allclose(
        tmm.chamfer_distance(pa, v2, device="cpu"),
        jmm.chamfer_distance(pa, v2), rtol=1e-5)
    np.testing.assert_allclose(
        tmm.mesh_chamfer(v, f, v2, f, n_samples=400, device="cpu"),
        jmm.mesh_chamfer(v, f, v2, f, n_samples=400), rtol=1e-5)
