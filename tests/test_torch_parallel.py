"""Port parity, the data-parallel step (d2dgs_torch/parallel/
data_parallel.py) and the command line's sharded stage: an 8-camera
batch split over 2, 4 and 8 gloo ranks (spawned processes,
tests/torch_parallel_workers.py) against the port's
``batched_main_step`` in one process, and that against the JAX
``batched_main_step`` (tests/test_parallel.py's cases, with its
tolerances); ``cli train --mesh_shape 1x1`` in one process and ``2x2``
under four ranks on a tiny D-NeRF scene."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_workers import (train_cfg, camera_arrays, camera_from,
                                    cli_ranks, dp_step_ranks, draws_arrays,
                                    load_state)

from d2dgs_torch import cli as tcli
from d2dgs_torch.io.checkpoint import load_train_state
from d2dgs_torch.models import regularizers as treg
from d2dgs_torch.parallel import batched_main_step
from d2dgs_torch.parallel.multihost import run_local
from d2dgs_torch.train.trainer import init_train_state
from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.synthetic import make_video_dataset
from d2dgs_tpu.parallel import batched_main_step as jbatched
from d2dgs_tpu.parallel import stack_cameras
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig

torch.set_num_threads(1)

BATCH = 8
JCFG = JTrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                    gaussian_capacity=256, node_gauss_capacity=64,
                    warm_up=0, raster=JRasterConfig(tile_cap=256, chunk=64,
                                                    use_pallas=False))
SCHED = dict(warm=0.0, lambda_normal=0.02, lambda_dist=100.0,
             lambda_arap=0.01, deform_lr=1e-3, xyz_lr=1e-4)
# the step's moments against the JAX package's, max-normalised: the
# distortion term's float32 noise (tests/test_torch_train.py STEP)
STEP = dict(rtol=2e-4, atol=1e-3)


def _leaves(state):
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cams, imgs, pts, cols = make_video_dataset(
        jax.random.PRNGKey(0), n_cams=4, n_times=2, H=32, W=32, n_gauss=8)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(1), JCFG,
                                       pts[:128], cols[:128])
    imgs = [np.asarray(i, np.float32) for i in imgs]
    draws = treg.arap_draws(torch.Generator().manual_seed(3), 16)
    arrays = dict(capacity=256, **_leaves(jstate), **draws_arrays(draws),
                  **{f"sched_{k}": v for k, v in SCHED.items()})
    for i, (c, im) in enumerate(zip(cams, imgs)):
        arrays.update(camera_arrays(c, f"cam{i}_"), **{f"gt{i}": im})
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **arrays)
    z = dict(np.load(inp))
    # the port's batch step in one process, on the carried-across state
    state = load_state(z)
    tcams = [camera_from(z, f"cam{i}_") for i in range(BATCH)]
    gts = torch.stack([torch.tensor(z[f"gt{i}"]) for i in range(BATCH)])
    ref_state, ref_m = batched_main_step(state, tcams, gts, train_cfg(z),
                                         SCHED, arap_draws=draws)
    return dict(tmp=tmp, inp=inp, cams=cams, imgs=imgs, jstate=jstate,
                ref=(ref_state, {k: float(v) for k, v in ref_m.items()}))


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_dp_step_matches_batched(data, ranks):
    out = str(data["tmp"] / f"dp{ranks}.pt")
    run_local(dp_step_ranks, ranks, data["inp"], out, BATCH,
              store=str(data["tmp"] / f"store{ranks}"))
    r = torch.load(out, weights_only=False)
    ref_state, ref_m = data["ref"]
    assert r["replicated_spread"] == 0.0
    np.testing.assert_allclose(r["metrics"]["loss"], ref_m["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(r["metrics"]["psnr"], ref_m["psnr"],
                               rtol=1e-5)
    for k in ("num_pairs", "overflow"):
        assert r["metrics"][k] == ref_m[k]
    got = r["summary"]
    np.testing.assert_allclose(got["gauss"]["xyz"].numpy(),
                               ref_state.gauss.xyz.detach().numpy(),
                               rtol=1e-4, atol=1e-6)
    st = ref_state.gauss_stats
    np.testing.assert_allclose(got["stats"][0].numpy(),
                               st.grad_accum.numpy(), rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(got["stats"][1].numpy(), st.denom.numpy())
    np.testing.assert_array_equal(got["stats"][2].numpy(),
                                  st.max_radii2d.numpy())


def test_batched_step_matches_jax(data):
    """The port's one-process batch step against the JAX package's: the
    loss, the densify counts and statistics, the Gaussians' moments."""
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    gts = jnp.stack([jnp.asarray(i) for i in data["imgs"][:BATCH]])
    js, jm = jax.jit(jbatched, static_argnames=("cfg",))(
        data["jstate"], stack_cameras(data["cams"][:BATCH]), gts, cfg=JCFG,
        sched=sched)
    ts, tm = data["ref"]
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["psnr"], float(jm["psnr"]), rtol=1e-5)
    np.testing.assert_array_equal(ts.gauss_stats.denom.numpy(),
                                  np.asarray(js.gauss_stats.denom))
    for port, ref in ((ts.gauss_stats.grad_accum, js.gauss_stats.grad_accum),
                      *((ts.gauss_opt.mu[k], js.gauss_opt.mu[k])
                        for k in ("xyz", "opacity", "features_dc"))):
        scale = float(np.abs(np.asarray(ref)).max()) + 1e-12
        np.testing.assert_allclose(port.numpy() / scale,
                                   np.asarray(ref) / scale, **STEP)


def test_batched_step_consistent_with_single(data):
    """A batch of B copies of one camera updates as the one-camera step
    does, and its densify counts count B observations."""
    from d2dgs_torch.train.trainer import main_stage_step
    z = dict(np.load(data["inp"]))
    cfg, draws = train_cfg(z), treg.arap_draws(
        torch.Generator().manual_seed(3), 16)
    cam = camera_from(z, "cam0_")
    gt = torch.tensor(z["gt0"])
    b_state, _ = batched_main_step(load_state(z), [cam] * 4,
                                   torch.stack([gt] * 4), cfg, SCHED,
                                   arap_draws=draws)
    s_state, _ = main_stage_step(load_state(z), cam, gt, cfg, SCHED,
                                 arap_draws=draws)
    np.testing.assert_allclose(b_state.gauss.xyz.detach().numpy(),
                               s_state.gauss.xyz.detach().numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b_state.gauss_stats.denom.numpy(),
                               4 * s_state.gauss_stats.denom.numpy(),
                               rtol=1e-6)


# ------------------------------------------------------------ the CLI

TINY = ["--sh_degree", "1", "--hyper_dim", "2", "--node_num", "16",
        "--gaussian_capacity", "512", "--node_gauss_capacity", "256",
        "--raster_tile_cap", "256", "--raster_chunk", "64",
        "--warm_up", "2", "--node_warm_up", "2",
        "--iterations_node_sampling", "3", "--iterations_node_rendering",
        "4", "--iterations", "6", "--densify_from_iter", "2",
        "--densification_interval", "3", "--oneup_sh_degree_step", "100",
        "--node_force_densify_prune_step", "100", "--log_every", "1",
        "--test_iterations", "3", "--save_iterations", "5"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from test_torch_data_io import dnerf_fixture
    return dnerf_fixture(tmp_path_factory.mktemp("dnerf_sharded"),
                         n_cams=4, n_times=2, H=32, W=32, n_test=2)


def _check_model(model):
    for f in ("ckpt.npz", "cfg_args.json",
              "point_cloud/iteration_5/point_cloud.ply"):
        assert os.path.exists(os.path.join(model, f)), f
    cfg = train_cfg({"capacity": 512})
    import dataclasses
    cfg = dataclasses.replace(cfg, node_gauss_capacity=256)
    template = init_train_state(cfg, np.zeros((4, 3), np.float32),
                                np.zeros((4, 3), np.float32), device="cpu")
    state, it, it_node = load_train_state(os.path.join(model, "ckpt.npz"),
                                          template)
    assert (it, it_node) == (8, 4)
    assert int(state.gauss.num_alive) > 0
    assert bool(torch.isfinite(state.gauss.xyz).all())
    return state


def test_cli_train_mesh_shape_1x1(scene_dir, tmp_path, capsys):
    """``--mesh_shape 1x1`` in one process (no process group) runs the
    sharded stage; its node stage and first main step log the losses of
    the run without it."""
    runs = {}
    for name, extra in (("plain", []), ("1x1", ["--mesh_shape", "1x1"])):
        model = str(tmp_path / name)
        report = {}
        assert tcli.main(["train", "-s", scene_dir, "-m", model, "--device",
                          "cpu", *TINY, *extra], report=report) == 0
        _check_model(model)
        runs[name] = report
    assert runs["1x1"]["exchange_cap"] % 256 == 0
    n = 4 + 1           # the node stage's steps, then one main step
    np.testing.assert_allclose(runs["1x1"]["loss"][:n],
                               runs["plain"]["loss"][:n], rtol=2e-4,
                               atol=1e-6)
    assert "nan" not in capsys.readouterr().out


def test_cli_train_mesh_shape_2x2(scene_dir, tmp_path):
    """``--mesh_shape 2x2`` on four ranks: one checkpoint, from rank 0, of
    the whole state; finite losses; the exchange sized from the scene."""
    model = str(tmp_path / "2x2")
    out = str(tmp_path / "cli.pt")
    argv = ["train", "-s", scene_dir, "-m", model, "--device", "cpu", *TINY,
            "--mesh_shape", "2x2"]
    run_local(cli_ranks, 4, argv, out, store=str(tmp_path / "store"))
    r = torch.load(out, weights_only=False)
    assert r["rc"] == 0
    assert np.isfinite(r["report"]["loss"]).all()
    assert r["report"]["exchange_cap"] % 256 == 0
    state = _check_model(model)
    assert state.gauss.capacity == 512
