"""Port parity, the sharded training step (d2dgs_torch/parallel/
gauss_train.py) on (data x gauss) grids of gloo ranks (spawned
processes, tests/torch_parallel_workers.py), from a JAX TrainState
carried across with io/from_jax.py.

The replicated reference is the port's ``main_stage_step`` (one data
row) or ``batched_main_step`` (two rows) on the same state with the same
ARAP draws; the JAX reference is its ``main_stage_step`` /
``batched_main_step`` and, at (1, 2), its ``sharded_train_step`` itself.
Tolerances are tests/test_sharded_train.py's: the loss to rtol 2e-4 and
atol 1e-6, ``xyz``/``opacity`` after the update to atol 5e-6 and rtol
1e-4, ``grad_accum`` to atol 1e-6 and rtol 1e-3, ``denom`` exactly.
Also the exchange's auto-sizing and the ``Trainer`` across a densify
boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_workers import (SCENE_KEYS, autosize_ranks,
                                    camera_arrays, camera_from,
                                    draws_arrays, load_state, make_trainer,
                                    sharded_step_ranks, trainer_ranks)

from d2dgs_torch.models import regularizers as treg
from d2dgs_torch.parallel import batched_main_step
from d2dgs_torch.parallel.multihost import run_local
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.synthetic import make_video_dataset
from d2dgs_tpu.parallel import batched_main_step as jbatched
from d2dgs_tpu.parallel import make_mesh2d as jmesh2d
from d2dgs_tpu.parallel import make_sharded_train_step as jsharded
from d2dgs_tpu.parallel import measure_exchange_counts as jmeasure
from d2dgs_tpu.parallel import shard_gauss_state as jshard
from d2dgs_tpu.parallel import stack_cameras
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_tpu.utils.quaternion import quat_normalize

torch.set_num_threads(1)

CAP = 256
JCFG = JTrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                    gaussian_capacity=CAP, node_gauss_capacity=64, warm_up=0,
                    raster=JRasterConfig(tile_cap=256, chunk=64,
                                         pair_cap=8192, use_pallas=False))
SCHED = dict(warm=0.0, lambda_normal=0.02, lambda_dist=100.0,
             lambda_arap=0.01, deform_lr=1e-3, xyz_lr=1e-4, step=100.0)
LOSS = dict(rtol=2e-4, atol=1e-6)
PARAM = dict(atol=5e-6, rtol=1e-4)
GRAD_ACCUM = dict(atol=1e-6, rtol=1e-3)
# max-normalised gradients: the JAX package's kernel tolerance
# (tests/test_pallas_blend.py)
GRAD = dict(rtol=2e-4, atol=2e-5)
GRIDS = [(1, 2), (2, 2), (2, 4), (1, 8)]
STEPS = 2


def _leaves(state):
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX scene and state (tests/test_sharded_train.py's), its
    arrays in an .npz for the ranks, and the draws of two steps."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    cams, imgs, pts, cols = make_video_dataset(
        jax.random.PRNGKey(0), n_cams=4, n_times=2, H=32, W=32, n_gauss=8)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(1), JCFG,
                                       pts[:128], cols[:128])
    imgs = [np.asarray(i, np.float32) for i in imgs]
    gen = torch.Generator().manual_seed(5)
    draws = [treg.arap_draws(gen, 16) for _ in range(STEPS)]
    arrays = dict(capacity=CAP, exchange_cap=4096, **_leaves(jstate),
                  **{f"sched_{k}": v for k, v in SCHED.items()})
    for i, (c, im) in enumerate(zip(cams, imgs)):
        arrays.update(camera_arrays(c, f"cam{i}_"), **{f"gt{i}": im})
    for s, d in enumerate(draws):
        arrays.update(draws_arrays(d, s))
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **arrays)
    return dict(tmp=tmp, inp=inp, cams=cams, imgs=imgs, jstate=jstate,
                draws=draws, pts=np.asarray(pts), cols=np.asarray(cols),
                z=dict(np.load(inp)))


@pytest.fixture(scope="module")
def grid_runs(data):
    runs = {}
    for shape in GRIDS:
        out = str(data["tmp"] / f"grid{shape[0]}x{shape[1]}.pt")
        run_local(sharded_step_ranks, shape[0] * shape[1], data["inp"], out,
                  shape, STEPS,
                  store=str(data["tmp"] / f"store{shape[0]}x{shape[1]}"))
        runs[shape] = torch.load(out, weights_only=False)
    return runs


def _replicated(data, n_data):
    """The port's replicated steps on the same state, cameras and draws:
    per step the metrics and the state's summary."""
    from torch_parallel_workers import train_cfg, state_summary
    z = data["z"]
    cfg, state = train_cfg(z), load_state(z)
    out = []
    for s in range(STEPS):
        idx = range(s * n_data, (s + 1) * n_data)
        cams = [camera_from(z, f"cam{i}_") for i in idx]
        gts = torch.stack([torch.tensor(z[f"gt{i}"]) for i in idx])
        if n_data == 1:
            state, m = ttrainer.main_stage_step(state, cams[0], gts[0], cfg,
                                                SCHED,
                                                arap_draws=data["draws"][s])
        else:
            state, m = batched_main_step(state, cams, gts, cfg, SCHED,
                                         arap_draws=data["draws"][s])
        out.append(({k: float(v) for k, v in m.items()},
                    state_summary(state)))
    return out


@pytest.fixture(scope="module")
def replicated(data):
    return {n: _replicated(data, n) for n in (1, 2)}


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_replicated(grid_runs, replicated, shape):
    """Two steps: the loss, the updated positions and opacities, the
    densify statistics and the deform MLP against the replicated step;
    no overflow; the replicated leaves the same on every rank."""
    r = grid_runs[shape]
    assert r["replicated_spread"] == 0.0
    for s, (rm, rsum) in enumerate(replicated[shape[0]]):
        m, got = r["metrics"][s], r["summaries"][s]
        assert m["overflow"] == 0
        np.testing.assert_allclose(m["loss"], rm["loss"], **LOSS)
        np.testing.assert_allclose(m["psnr"], rm["psnr"], rtol=2e-4)
        assert m["alive"] == 128
        for k in ("xyz", "opacity"):
            np.testing.assert_allclose(got["gauss"][k].numpy(),
                                       rsum["gauss"][k].numpy(), **PARAM,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(got["stats"][0].numpy(),
                                   rsum["stats"][0].numpy(), **GRAD_ACCUM)
        np.testing.assert_array_equal(got["stats"][1].numpy(),
                                      rsum["stats"][1].numpy())
        np.testing.assert_array_equal(got["stats"][2].numpy(),
                                      rsum["stats"][2].numpy())
        if s:
            continue
        # the deform MLP's first moments after the first step, 0.1 of its
        # gradient (an Adam step moves a weight by about +-lr whatever its
        # gradient's size, so later steps start from weights that differ
        # where a gradient is weak), max-normalised per array
        for k, v in rsum["mlp_mu"].items():
            scale = float(v.abs().max()) + 1e-12
            np.testing.assert_allclose(got["mlp_mu"][k].numpy() / scale,
                                       v.numpy() / scale, **GRAD, err_msg=k)
    assert float(r["summaries"][-1]["stats"][1].max()) == STEPS * shape[0]
    assert float(r["summaries"][0]["mlp_mu"]["layers.0.w"].abs().max()) > 0


def _jax_batch(data, n_data):
    gts = jnp.stack([jnp.asarray(i) for i in data["imgs"][:n_data]])
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    if n_data == 1:
        return jtrainer.main_stage_step(data["jstate"], data["cams"][0],
                                        gts[0], JCFG, sched)
    return jax.jit(jbatched, static_argnames=("cfg",))(
        data["jstate"], stack_cameras(data["cams"][:n_data]), gts, cfg=JCFG,
        sched=sched)


@pytest.mark.parametrize("n_data", [1, 2])
def test_first_step_matches_jax(data, grid_runs, n_data):
    """The first step against the JAX package's replicated step: the loss
    and PSNR, the densify statistics, and the Gaussians' update (which no
    ARAP draw reaches)."""
    js, jm = _jax_batch(data, n_data)
    for shape in GRIDS:
        if shape[0] != n_data:
            continue
        m, got = grid_runs[shape]["metrics"][0], \
            grid_runs[shape]["summaries"][0]
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), **LOSS)
        np.testing.assert_allclose(m["psnr"], float(jm["psnr"]), rtol=2e-4)
        np.testing.assert_array_equal(got["stats"][1].numpy(),
                                      np.asarray(js.gauss_stats.denom))
        np.testing.assert_allclose(got["stats"][0].numpy(),
                                   np.asarray(js.gauss_stats.grad_accum),
                                   **GRAD_ACCUM)
        for k in ("xyz", "opacity"):
            np.testing.assert_allclose(got["gauss"][k].numpy(),
                                       np.asarray(getattr(js.gauss, k)),
                                       **PARAM, err_msg=f"{shape} {k}")


def test_first_step_matches_jax_sharded_step(data, grid_runs):
    """The JAX sharded step itself on its (1, 2) mesh of virtual
    devices."""
    mesh = jmesh2d(1, 2)
    step = jsharded(mesh, JCFG, exchange_cap=4096)
    js, jm = step(jshard(mesh, data["jstate"]),
                  stack_cameras(data["cams"][:1]),
                  jnp.asarray(data["imgs"][0])[None],
                  {k: jnp.float32(v) for k, v in SCHED.items()})
    m, got = grid_runs[(1, 2)]["metrics"][0], \
        grid_runs[(1, 2)]["summaries"][0]
    assert int(jm["overflow"]) == 0 == m["overflow"]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), **LOSS)
    np.testing.assert_array_equal(got["stats"][1].numpy(),
                                  np.asarray(js.gauss_stats.denom))
    np.testing.assert_allclose(got["stats"][0].numpy(),
                               np.asarray(js.gauss_stats.grad_accum),
                               **GRAD_ACCUM)
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(got["gauss"][k].numpy(),
                                   np.asarray(getattr(js.gauss, k)), **PARAM)


def test_exchange_autosizing(data):
    """The measured largest record count (the JAX package's, exactly), a
    suggested cap at or above it in multiples of 256, and no overflow at
    that cap, on a 1 x 4 grid."""
    g = data["jstate"].gauss
    scene = dict(means=np.asarray(g.xyz), scales=np.asarray(g.get_scaling),
                 quats=np.asarray(quat_normalize(g.rotation, eps=1e-12)),
                 opacity=np.asarray(g.get_opacity[:, 0]),
                 colors=np.zeros((CAP, 3), np.float32),
                 alive=np.asarray(g.alive))
    inp = str(data["tmp"] / "autosize.npz")
    np.savez(inp, **{k: scene[k] for k in SCENE_KEYS},
             **camera_arrays(data["cams"][0], "cam0_"),
             **camera_arrays(data["cams"][1], "cam1_"))
    out = str(data["tmp"] / "autosize.pt")
    run_local(autosize_ranks, 4, inp, out,
              store=str(data["tmp"] / "store_autosize"))
    r = torch.load(out, weights_only=False)
    mesh = jmesh2d(1, 4)
    jmx = jmeasure(mesh, data["cams"][0], g.xyz, g.get_scaling,
                   quat_normalize(g.rotation, eps=1e-12), g.alive,
                   JCFG.raster)
    assert r["max_count"] == jmx > 0
    assert r["cap"] >= r["max_count"] and r["cap"] % 256 == 0
    assert r["overflow"] == 0


def _trainer_inputs(data):
    z = {"capacity": CAP, "exchange_cap": 4096, "n_cams": 8,
         "points": (np.random.RandomState(0).randn(64, 3) * 0.4).astype(
             np.float32),
         "colors": np.full((64, 3), 0.5, np.float32)}
    for i, (c, im) in enumerate(zip(data["cams"], data["imgs"])):
        z.update(camera_arrays(c, f"cam{i}_"), **{f"gt{i}": im})
    inp = str(data["tmp"] / "trainer.npz")
    np.savez(inp, **z)
    return inp


def test_trainer_sharded_main_stage_matches_unsharded(data):
    """The Trainer on a 1 x 2 grid through its node stage and three main
    steps, the last followed by a densify on the sharded state, ends where
    the unsharded Trainer ends: the same losses, the same Gaussians alive,
    the same positions, opacities and observation counts."""
    inp = _trainer_inputs(data)
    out = str(data["tmp"] / "trainer12.pt")
    tr = make_trainer(dict(np.load(inp)))
    steps = tr.cfg.iterations_node_rendering + tr.cfg.densification_interval
    run_local(trainer_ranks, 2, inp, out, (1, 2), steps,
              store=str(data["tmp"] / "store_trainer12"))
    r = torch.load(out, weights_only=False)
    losses = []
    for _ in range(steps):
        m = tr.step()
        if m:
            losses.append(float(m["loss"]))
    assert r["overflow"] == 0 and r["iteration"] == tr.iteration
    np.testing.assert_allclose(r["losses"], losses, **LOSS)
    got = r["summary"]
    assert torch.equal(got["alive"], tr.state.gauss.alive)
    assert int(got["alive"].sum()) != 64     # densify changed the set
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(got["gauss"][k].numpy(),
                                   getattr(tr.state.gauss, k).detach()
                                   .numpy(), **PARAM)
    np.testing.assert_array_equal(got["stats"][1].numpy(),
                                  tr.state.gauss_stats.denom.numpy())


def test_trainer_sharded_2x2(data):
    """tests/test_sharded_train.py's Trainer case on a 2 x 2 grid: finite
    losses, no overflow, densify statistics accumulated."""
    inp = _trainer_inputs(data)
    out = str(data["tmp"] / "trainer22.pt")
    steps = make_trainer(dict(np.load(inp))).total_iterations()
    run_local(trainer_ranks, 4, inp, out, (2, 2), steps,
              store=str(data["tmp"] / "store_trainer22"))
    r = torch.load(out, weights_only=False)
    assert len(r["losses"]) >= 8 and np.isfinite(r["losses"]).all()
    assert r["overflow"] == 0
    assert float(r["summary"]["stats"][1].sum()) > 0


def test_with_trainable_roundtrip(data):
    """with_trainable / with_node_trainable put the given leaves in place
    and keep the rest."""
    st = load_state(data["z"])
    g2 = ttrainer.with_trainable(
        st.gauss, {"xyz": st.gauss.xyz.detach() + 1.0})
    assert torch.equal(g2.xyz, st.gauss.xyz.detach() + 1.0)
    assert torch.equal(g2.opacity, st.gauss.opacity.detach())
    mlp = {k: v.detach() * 2.0
           for k, v in ttrainer.mlp_trainable(st.nodes).items()}
    n2 = ttrainer.with_node_trainable(
        st.nodes, {"node_radius": st.nodes.node_radius.detach() - 1.0}, mlp)
    for k, v in ttrainer.mlp_trainable(n2).items():
        assert torch.equal(v, mlp[k])
    assert torch.equal(n2.node_radius, st.nodes.node_radius.detach() - 1.0)
    assert torch.equal(n2.nodes, st.nodes.nodes.detach())
    n3 = ttrainer.with_node_trainable(st.nodes, {}, st.nodes.mlp)
    assert n3.mlp is st.nodes.mlp


def test_gauss_sharded_step_one_process(data):
    """With no process group a 1 x 1 grid runs the sharded path in one
    process (the slab blend's map the identity, the collectives skipped):
    ``gauss_sharded_step`` (the geometric terms off unless given) equals
    ``main_stage_step`` with them off."""
    from d2dgs_torch.parallel import gauss_sharded_step, make_gauss_mesh
    from torch_parallel_workers import state_summary, train_cfg
    z = data["z"]
    mesh = make_gauss_mesh(1)
    assert mesh.gauss_group is None and not mesh.world
    cam, gt = camera_from(z, "cam0_"), torch.tensor(z["gt0"])
    sched = dict(warm=0.0, deform_lr=1e-3, xyz_lr=1e-4, step=100.0)
    off = dict(sched, lambda_normal=0.0, lambda_dist=0.0, lambda_arap=0.0)
    s1, m1 = gauss_sharded_step(load_state(z), cam, gt, sched, train_cfg(z),
                                mesh, arap_draws=data["draws"][0])
    s2, m2 = ttrainer.main_stage_step(load_state(z), cam, gt, train_cfg(z),
                                      off, arap_draws=data["draws"][0])
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), **LOSS)
    assert int(m1["overflow"]) == 0 and int(m1["alive"]) == 128
    a, b = state_summary(s1), state_summary(s2)
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(a["gauss"][k].numpy(),
                                   b["gauss"][k].numpy(), **PARAM)
    np.testing.assert_array_equal(a["stats"][1].numpy(),
                                  b["stats"][1].numpy())
