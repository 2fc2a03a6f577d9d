"""Port parity, the two-stage trainer's maintenance and loop:
densify/prune, opacity reset, node densification, the stage-1
downsampling and its neighbours, the ``Trainer``'s schedule against the
JAX trainer's, and a short CPU training run of the port.

Every comparison starts from the same JAX TrainState carried across by
d2dgs_torch.io.from_jax, and the JAX package's random draws are handed
to the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.synthetic import make_video_dataset
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.train.config import TrainConfig
from test_torch_train import CFG, JCFG, T, _jax_state
from test_torch_trainer import CFG_D, JCFG_D, _port

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)


def _rich_state():
    """The test_torch_train state with 60 live node Gaussians spread over
    the view (the JAX trainer starts them on the 16 nodes), random Adam
    moments in every group and densify statistics on both point sets."""
    st = _jax_state()
    rs = np.random.RandomState(11)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    ng = st.ngauss
    cap = ng.capacity
    alive = np.zeros(cap, bool)
    alive[:60] = True
    ng = dataclasses.replace(
        ng, xyz=f32(rs.normal(size=(cap, 3)) * 0.5),
        features_dc=f32(rs.normal(size=ng.features_dc.shape) * 0.5),
        opacity=f32(rs.normal(size=(cap, 1))),
        scaling=f32(np.full((cap, 2), np.log(0.08))),
        alive=jnp.asarray(alive))

    def moments(opt):
        tree = lambda t: jax.tree.map(
            lambda a: f32(rs.normal(size=a.shape) * 1e-3), t)
        return opt._replace(mu=tree(opt.mu),
                            nu=jax.tree.map(jnp.abs, tree(opt.nu)),
                            count=jnp.int32(3))

    def stats(c):
        return st.gauss_stats._replace(
            grad_accum=f32(np.abs(rs.normal(size=c)) * 4e-4),
            denom=f32(rs.randint(0, 4, size=c)),
            max_radii2d=f32(rs.uniform(0, 30, size=c)))
    return st._replace(
        ngauss=ng, gauss_opt=moments(st.gauss_opt),
        ngauss_opt=moments(st.ngauss_opt), node_opt=moments(st.node_opt),
        mlp_opt=moments(st.mlp_opt),
        gauss_stats=stats(st.gauss.capacity),
        ngauss_stats=stats(cap))


@pytest.fixture(scope="module")
def jstate():
    return _rich_state()


def _same(port, ref, what, exact=False):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    if exact:
        np.testing.assert_array_equal(port, np.asarray(ref), err_msg=what)
    else:
        np.testing.assert_allclose(port, np.asarray(ref), rtol=1e-6,
                                   atol=1e-6, err_msg=what)


def _compare_points(tp, topt, jp, jopt, what):
    """Every trainable array, alive, and the Adam moments of a point set
    (after densify: the same slots, to float32 rounding)."""
    for k in ttrainer.GAUSS_FIELDS:
        _same(getattr(tp, k), getattr(jp, k), f"{what} {k}")
        _same(topt.mu[k], jopt.mu[k], f"{what} mu.{k}")
        _same(topt.nu[k], jopt.nu[k], f"{what} nu.{k}")
    _same(tp.alive, jp.alive, f"{what} alive", exact=True)


# ------------------------------------------------ densify and reset

@pytest.mark.parametrize("which,prune_big,extent",
                         [("main", False, 8.0), ("main", True, 8.0),
                          ("node", True, 4.0)])
def test_densify_and_prune_matches_jax(jstate, which, prune_big, extent):
    """densify_step slot for slot: clones, splits (with JAX's split noise),
    the capacity overflow, pruning, zeroed moments and reset stats.  At
    extent 8 the main Gaussians (scales ~0.08) both clone and split; the
    node Gaussians' shared scale 0.08 splits at extent 4; at this
    threshold both run out of free slots."""
    grad_max = 5e-5
    js, jinfo = jtrainer.densify_step(jstate, JCFG, which, extent, 0.3,
                                      prune_big, grad_max)
    c = (jstate.gauss if which == "main" else jstate.ngauss).capacity
    noise = T(jax.random.normal(jax.random.split(jstate.key)[1], (2, c, 2)))
    ts, tinfo = ttrainer.densify_step(_port(jstate), CFG, which, extent, 0.3,
                                      prune_big, grad_max, noise=noise)
    for k in ("clones", "splits", "pruned", "overflow"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(jinfo["splits"]) > 0 and int(jinfo["pruned"]) > 0
    assert int(jinfo["overflow"]) > 0
    if which == "main":
        assert int(jinfo["clones"]) > 0
        _compare_points(ts.gauss, ts.gauss_opt, js.gauss, js.gauss_opt,
                        "gauss")
        stats = ts.gauss_stats
    else:
        _compare_points(ts.ngauss, ts.ngauss_opt, js.ngauss, js.ngauss_opt,
                        "ngauss")
        assert ts.ngauss.isotropic_shared_scale
        stats = ts.ngauss_stats
    assert all(float(a.abs().sum()) == 0 for a in stats)


@pytest.mark.parametrize("which", ["main", "node"])
def test_reset_opacity_matches_jax(jstate, which):
    js = jtrainer.reset_opacity_step(jstate, which)
    ts = ttrainer.reset_opacity_step(_port(jstate), which)
    tp, topt, jp, jopt = ((ts.gauss, ts.gauss_opt, js.gauss, js.gauss_opt)
                          if which == "main" else
                          (ts.ngauss, ts.ngauss_opt, js.ngauss, js.ngauss_opt))
    _compare_points(tp, topt, jp, jopt, which)
    assert float(torch.sigmoid(tp.opacity.detach()).max()) <= 0.01 + 1e-6
    assert float(topt.mu["opacity"].abs().sum()) == 0


def test_node_densify_step_matches_jax(jstate):
    """densify_nodes through node_densify_step: three dead node slots to
    fill, the importance vote, added and pruned nodes, zeroed moments."""
    alive = np.ones(16, bool)
    alive[[2, 9, 13]] = False
    js0 = jstate._replace(nodes=dataclasses.replace(
        jstate.nodes, alive=jnp.asarray(alive)))
    grad_max = 1.5e-4
    js, jinfo = jtrainer.node_densify_step(js0, JCFG, grad_max)
    ts, tinfo = ttrainer.node_densify_step(_port(js0), CFG, grad_max)
    for k in ("added", "pruned"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(jinfo["added"]) > 0
    for k in ttrainer.NODE_FIELDS:
        _same(getattr(ts.nodes, k), getattr(js.nodes, k), f"nodes.{k}")
        _same(ts.node_opt.mu[k], js.node_opt.mu[k], f"mu.{k}")
        _same(ts.node_opt.nu[k], js.node_opt.nu[k], f"nu.{k}")
    _same(ts.nodes.alive, js.nodes.alive, "alive", exact=True)


# ------------------------------------- downsampling and its neighbours

def test_node_downsample_and_stage_transitions_match_jax(jstate):
    """node_downsample_step with JAX's FPS start, then adopt_node_positions,
    and oneup_sh on the main Gaussians."""
    js = jtrainer.node_downsample_step(jstate, JCFG)
    k_fps = jax.random.split(jstate.key)[1]
    start = int(jax.random.categorical(
        k_fps, jnp.where(jstate.ngauss.alive, 0.0, -jnp.inf)))
    ts = ttrainer.node_downsample_step(_port(jstate), CFG, fps_start=start)
    for k in ttrainer.NODE_FIELDS:
        _same(getattr(ts.nodes, k), getattr(js.nodes, k), f"nodes.{k}")
        assert float(ts.node_opt.mu[k].abs().sum()) == 0
    _same(ts.nodes.alive, js.nodes.alive, "nodes.alive", exact=True)
    for k in ttrainer.GAUSS_FIELDS:
        _same(getattr(ts.ngauss, k), getattr(js.ngauss, k), f"ngauss.{k}")
    _same(ts.ngauss.alive, js.ngauss.alive, "ngauss.alive", exact=True)
    assert int(ts.ngauss.num_alive) == CFG.node_num
    assert int(ts.ngauss_opt.count) == 0 == int(js.ngauss_opt.count)
    assert all(float(a.abs().sum()) == 0 for a in ts.ngauss_stats)

    js = jtrainer.adopt_node_positions(js)
    ts = ttrainer.adopt_node_positions(ts)
    _same(ts.nodes.nodes, js.nodes.nodes, "adopted nodes")

    for _ in range(2):
        js = jtrainer.oneup_sh(js, JCFG)
        ts = ttrainer.oneup_sh(ts, CFG)
        assert ts.gauss.active_sh_degree == int(js.gauss.active_sh_degree)
    assert ts.gauss.active_sh_degree == ts.gauss.max_sh_degree == 1


# ------------------------------------------------- the Trainer loop

# a schedule short enough that every branch fires: node-stage densify
# (at 5, 10 and node_warm_up - 1) and opacity reset (6), downsampling
# (12), adopt (14), SH step-up (4, 8, 12), node densify (7), main-stage
# densify (5, 10) and opacity reset (6, 12)
SCHEDULE = dict(node_warm_up=4, iterations_node_sampling=12,
                iterations_node_rendering=15, iterations=14, warm_up=3,
                densification_interval=5, densify_from_iter=2,
                opacity_reset_interval=6, oneup_sh_degree_step=4,
                node_force_densify_prune_step=7, densify_until_iter=13,
                normal_dist_from_iter=5)


@pytest.mark.parametrize("is_blender", [True, False])
def test_trainer_schedule_matches_jax(monkeypatch, is_blender):
    """Both Trainers on the same config and seed, with every step function
    replaced by a recorder that returns the state unchanged: the same
    sequence of (call, stage iteration, camera index, camera time)."""
    jcfg = dataclasses.replace(JCFG_D, is_blender=is_blender, **SCHEDULE)
    tcfg = dataclasses.replace(CFG_D, is_blender=is_blender, **SCHEDULE)
    cams, imgs, pts, cols = make_video_dataset(0, n_cams=3, n_times=2, H=16,
                                               W=16, n_gauss=8, device="cpu")
    jcams = [jorbit(0.0, 0.3, 4.0, fov=0.9, H=16, W=16, time=float(c.time))
             for c in cams]

    def run(mod, cfg, cameras):
        log = []
        tr = mod.Trainer(cfg, cameras, imgs, pts, cols, cameras_extent=4.0,
                         seed=3, **({} if mod is jtrainer else
                                    {"device": "cpu"}))

        def recorder(name, returns_info, camera_arg):
            def fn(state, *a, **k):
                it = tr.iteration_node if name.startswith(("node_stage",
                                                           "node_down")) \
                    or tr.iteration_node < cfg.iterations_node_rendering \
                    else tr.iteration
                entry = [name, it]
                if camera_arg:
                    entry += [tr._last_cam_idx, round(float(a[0].time), 6)]
                log.append(tuple(entry))
                if camera_arg:
                    return state, {"loss": 0.0}
                return (state, {}) if returns_info else state
            return fn

        for name, info, cam in (
                ("node_stage_step", True, True),
                ("main_stage_step", True, True),
                ("densify_step", True, False),
                ("reset_opacity_step", False, False),
                ("node_downsample_step", False, False),
                ("adopt_node_positions", False, False),
                ("node_densify_step", True, False),
                ("oneup_sh", False, False)):
            monkeypatch.setattr(mod, name, recorder(name, info, cam))
        tr.train()
        return log

    jlog = run(jtrainer, jcfg, jcams)
    tlog = run(ttrainer, tcfg, cams)
    assert tlog == jlog
    names = {e[0] for e in tlog}
    assert names == {"node_stage_step", "main_stage_step", "densify_step",
                     "reset_opacity_step", "node_downsample_step",
                     "adopt_node_positions", "node_densify_step",
                     "oneup_sh"}
    resets = [e for e in tlog if e[0] == "reset_opacity_step"]
    assert len(resets) >= 2


# the tiny configuration of tests/test_trainer.py (widths, caps and the
# ratios of its stage-1 schedule), its stage 1 cut to a third of the steps
TINY = TrainConfig(
    sh_degree=1, hyper_dim=2, node_num=16, gaussian_capacity=512,
    node_gauss_capacity=256, warm_up=30,
    node_warm_up=40, iterations_node_sampling=90,
    iterations_node_rendering=110, iterations=400,
    densification_interval=25, densify_from_iter=20,
    opacity_reset_interval=10_000, normal_dist_from_iter=150,
    oneup_sh_degree_step=100, node_force_densify_prune_step=1_000,
    raster=RasterConfig(tile_cap=256, chunk=64, use_workqueue=False))


def test_trainer_trains_on_cpu():
    """Stage 1 of the port's Trainer on a synthetic video, then a few
    main-stage steps: stage-1 PSNR rises, the node Gaussians collapse to
    node_num at the downsampling, and everything stays finite."""
    cams, imgs, pts, cols = make_video_dataset(3, n_cams=6, n_times=3, H=48,
                                               W=48, n_gauss=16,
                                               device="cpu")
    tr = ttrainer.Trainer(TINY, cams, imgs, pts, cols, cameras_extent=4.0,
                          seed=0, device="cpu")
    psnrs = []
    while tr.iteration_node < TINY.iterations_node_rendering:
        m = tr.step()
        if m:
            psnrs.append(float(m["psnr"]))
            assert int(m["overflow"]) == 0
    assert len(psnrs) == TINY.iterations_node_rendering - 2
    assert np.isfinite(psnrs).all()
    assert np.mean(psnrs[-5:]) > np.mean(psnrs[:5]) + 3.0
    assert int(tr.state.ngauss.num_alive) == TINY.node_num
    np.testing.assert_array_equal(
        tr.state.nodes.nodes[:, :3].detach().numpy(),
        tr.state.ngauss.xyz[:TINY.node_num].detach().numpy())
    for _ in range(5):
        m = tr.step()
        assert np.isfinite(float(m["loss"]))
    assert tr.iteration == 6
    # gt alpha masks are taken (the motion-mask loss), and so are flow
    # files (the optical-flow loss, tests/test_torch_flow.py)
    alphas = [im[..., :1] for im in imgs]
    tr = ttrainer.Trainer(TINY, cams, imgs, pts, cols, alphas=alphas,
                          device="cpu")
    assert tr.alphas[0].shape == (48, 48, 1)
    names = [f"{i:03d}.png" for i in range(18)]
    tr = ttrainer.Trainer(TINY, cams, imgs, pts, cols, flow_dirs=[[]] * 18,
                          image_names=names, device="cpu")
    assert tr.flow_dirs == [[]] * 18 and tr._name2idx["017"] == 17
    assert tr._pick_flow_sample(0) is None      # no candidate file
