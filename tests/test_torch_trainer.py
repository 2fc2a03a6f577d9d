"""Port parity, the two-stage trainer's steps: the node-stage
regularizers, the linear noise schedule and masked FPS, and both training
steps on the dense blend route (the JAX side runs its K3/K4 Pallas kernels
in interpret mode).  The maintenance steps and the ``Trainer`` loop are in
tests/test_torch_trainer_loop.py.

Every comparison starts from the same JAX TrainState carried across by
d2dgs_torch.io.from_jax, and the JAX package's random draws are handed
to the port.  Tolerances of a training step are those of
tests/test_torch_train.py (the distortion term's float32 noise)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.models import regularizers as jreg
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.io.from_jax import train_state_from_jax_arrays
from d2dgs_torch.models import densify as tdensify
from d2dgs_torch.models import regularizers as treg
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.utils import general as tgeneral
from test_torch_train import (CAM, CFG, JCFG, SCHED, STEP, T, _arap_draws,
                              _flat, _jax_state, _leaves, close_normalised)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

# the dense blend route on both sides: JAX's K3/K4 in interpret mode
JCFG_D = dataclasses.replace(
    JCFG, raster=dataclasses.replace(JCFG.raster, use_workqueue=False))
CFG_D = dataclasses.replace(
    CFG, raster=RasterConfig(tile_cap=256, use_workqueue=False))
TIME_INTERVAL = 1.0 / 12


@pytest.fixture(scope="module")
def fresh_state():
    """The test_torch_train state (fresh Adam moments and statistics), for
    the step comparisons."""
    return _jax_state()


def _port(js):
    return train_state_from_jax_arrays(_leaves(js), device="cpu")


# ------------------------------------------------------- regularizers

def test_elastic_and_acc_loss_match_jax(fresh_state):
    """Values and gradients (MLP, node positions, radii and weights) of
    the node-stage regularizers with JAX's draws handed to the port.  Both
    divide each term by its own detached value, so values are ~1 and held
    to 1e-5; gradients as the ARAP term's (atol 5e-4 of the group's
    largest entry)."""
    jstate = fresh_state
    st = _port(jstate)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    el_draws = treg.TimeDraws(T(jax.random.uniform(k1)),
                              T(jax.random.uniform(k2, (8,))))
    acc_draws = treg.TimeDraws(T(jax.random.uniform(key)), torch.zeros(0))
    t = 0.4
    cfg_j, cfg_t = JCFG.node_cfg, CFG.node_cfg
    cases = [
        ("elastic",
         lambda n: jreg.elastic_loss(n, cfg_j, key, t=t,
                                     delta_t=TIME_INTERVAL),
         lambda n: treg.elastic_loss(n, cfg_t, el_draws, t=t,
                                     delta_t=TIME_INTERVAL)),
        ("acc",
         lambda n: jreg.acc_loss(n, cfg_j, key, t=t,
                                 delta_t=3 * TIME_INTERVAL),
         lambda n: treg.acc_loss(n, cfg_t, acc_draws, t=t,
                                 delta_t=3 * TIME_INTERVAL)),
    ]
    for name, jf, tf in cases:
        def jloss(mlp, node_train):
            return jf(jtrainer.with_node_trainable(jstate.nodes, node_train,
                                                   mlp))
        jl, (jg_mlp, jg_node) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jstate.nodes.mlp, jtrainer.node_trainable(jstate.nodes))
        tl = tf(st.nodes)
        assert float(jl) > 0
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                                   err_msg=name)
        params = {**ttrainer.mlp_trainable(st.nodes),
                  **ttrainer.node_trainable(st.nodes)}
        tg = torch.autograd.grad(tl, list(params.values()), allow_unused=True)
        jflat = {**_flat(jg_mlp), **jg_node}
        scale = max(float(np.abs(np.asarray(v)).max())
                    for v in jflat.values())
        assert scale > 0
        for (k, p), g in zip(params.items(), tg):
            g = torch.zeros_like(p) if g is None else g
            np.testing.assert_allclose(g.numpy() / scale,
                                       np.asarray(jflat[k]) / scale,
                                       rtol=2e-4, atol=5e-4,
                                       err_msg=f"{name} d {k}")
    # the landmark schedule is the JAX one
    for step in (0, 1, 2_500, 5_000, 7_000, 10_000, 20_000, 30_000):
        for args in (([5e-1, 1e-2, 0.0], [0, 10_000, 10_001]),
                     ([1e-4, 1e-4, 1e-5, 1e-5, 0],
                      [0, 5000, 10000, 20000, 20001]), ([0], [0])):
            assert treg.landmark_interpolate(*args, step=step) == \
                pytest.approx(jreg.landmark_interpolate(*args, step=step),
                              rel=1e-12)


def test_linear_noise_and_masked_fps_match_jax():
    from d2dgs_tpu.utils import general as jgeneral
    kw = dict(lr_init=0.1, lr_final=1e-15, lr_delay_mult=0.01,
              max_steps=20_000)
    j, t = jgeneral.get_linear_noise_func(**kw), \
        tgeneral.get_linear_noise_func(**kw)
    for step in (-1, 0, 1, 500, 19_999, 30_000):
        assert t(step) == j(step)
    pts = np.random.RandomState(2).normal(size=(200, 6)).astype(np.float32)
    mask = np.random.RandomState(3).uniform(size=200) > 0.3
    key = jax.random.PRNGKey(4)
    ji = np.asarray(jgeneral.farthest_point_sample(
        key, jnp.asarray(pts), 32, mask=jnp.asarray(mask)))
    ti = tgeneral.farthest_point_sample(T(pts), 32, start=int(ji[0]),
                                        mask=T(mask))
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert mask[ji].all()
    drawn = tgeneral.farthest_point_sample(
        T(pts), 8, generator=torch.Generator().manual_seed(0), mask=T(mask))
    assert mask[drawn.numpy()].all()


# ----------------------------------------------------- the two steps

def _compare_groups(ts, tm, js, jm, points, what, xyz_lr, deform_lr):
    """Loss, PSNR, counters, the three Adam groups and the densify stats
    after one step (as tests/test_torch_train.py's _compare_step, for
    either point set)."""
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=f"{what} {k}")
    for k in ("num_pairs", "overflow"):
        assert int(tm[k]) == int(jm[k]), (what, k)
    tp, jp = getattr(ts, points), getattr(js, points)
    opt = "gauss_opt" if points == "gauss" else "ngauss_opt"
    groups = [
        (points, ttrainer.gauss_trainable(tp), getattr(ts, opt),
         jtrainer.gauss_trainable(jp), getattr(js, opt),
         ttrainer.gauss_lr_tree(CFG, xyz_lr)),
        ("node", ttrainer.node_trainable(ts.nodes), ts.node_opt,
         jtrainer.node_trainable(js.nodes), js.node_opt,
         dict.fromkeys(ttrainer.NODE_FIELDS, CFG.deform_lr_init)),
        ("mlp", ttrainer.mlp_trainable(ts.nodes), ts.mlp_opt,
         _flat(js.nodes.mlp), js.mlp_opt._replace(mu=_flat(js.mlp_opt.mu),
                                                  nu=_flat(js.mlp_opt.nu)),
         dict.fromkeys(_flat(js.nodes.mlp), deform_lr)),
    ]
    for gname, tg, topt, jg, jopt, lr in groups:
        assert int(topt.count) == int(jopt.count), (what, gname)
        for k in tg:
            if tg[k].numel() == 0:
                continue
            tag = f"{what} {gname}.{k}"
            mu = np.asarray(jopt.mu[k])
            close_normalised(topt.mu[k], mu, tol=STEP, what=tag + " mu")
            close_normalised(topt.nu[k], jopt.nu[k], tol=STEP,
                             what=tag + " nu")
            strong = np.abs(mu) > 0.1 * np.abs(mu).max()
            np.testing.assert_allclose(
                tg[k].detach().numpy()[strong], np.asarray(jg[k])[strong],
                rtol=0, atol=0.02 * lr[k] + 1e-6, err_msg=tag + " param")
    stats = "gauss_stats" if points == "gauss" else "ngauss_stats"
    for f in tdensify.DensifyStats._fields:
        close_normalised(getattr(getattr(ts, stats), f),
                         getattr(getattr(js, stats), f), tol=STEP,
                         what=f"{what} stats.{f}")


def test_node_stage_step_two_steps_match_jax(fresh_state):
    """Node-stage steps on the dense route: at warm 1 / reg_on 0 and,
    each from the JAX state after the last, at warm 0 / reg_on 1 (the
    elastic, acceleration and ARAP terms on, with JAX's draws), then again
    with the stage-1 motion-mask term against a gt alpha mask."""
    rs = np.random.RandomState(9)
    gt = rs.uniform(size=(32, 32, 3)).astype(np.float32)
    alpha = (rs.uniform(size=(32, 32, 1)) > 0.5).astype(np.float32)
    jcam, tcam = jorbit(**CAM), orbit_camera(**CAM, device="cpu")
    js = fresh_state
    for warm, reg_on, motion in ((1.0, 0.0, False), (0.0, 1.0, False),
                                 (0.0, 1.0, True)):
        sched = dict(warm=warm, reg_on=reg_on, deform_lr=8e-4, xyz_lr=8e-4,
                     time_interval=TIME_INTERVAL, step=5.0)
        ts = _port(js)
        _, k_arap, k_el, k_acc = jax.random.split(js.key, 4)
        e1, e2 = jax.random.split(k_el)
        draws = dict(
            arap_draws=_arap_draws(k_arap, 16),
            elastic_draws=treg.TimeDraws(T(jax.random.uniform(e1)),
                                         T(jax.random.uniform(e2, (8,)))),
            acc_draws=treg.TimeDraws(T(jax.random.uniform(k_acc)),
                                     torch.zeros(0)))
        motion_kw = lambda a: dict(gt_alpha=a, motion_loss=True) \
            if motion else {}
        js, jm = jtrainer.node_stage_step(
            js, jcam, jnp.asarray(gt), JCFG_D,
            {k: jnp.float32(v) for k, v in sched.items()},
            **motion_kw(jnp.asarray(alpha)))
        ts, tm = ttrainer.node_stage_step(ts, tcam, T(gt), CFG_D, sched,
                                          **motion_kw(T(alpha)), **draws)
        _compare_groups(ts, tm, js, jm, "ngauss",
                        f"warm {warm} motion {motion}", 8e-4, 8e-4)
        assert float(ts.ngauss_stats.denom.max()) >= 1


def test_main_stage_step_dense_route_matches_jax(fresh_state):
    """One main-stage step on the dense route (K3/K4 on the JAX side)."""
    gt = np.random.RandomState(9).uniform(size=(32, 32, 3))
    gt = gt.astype(np.float32)
    sched = dict(SCHED, warm=0.0)
    js = fresh_state
    ts = _port(js)
    draws = _arap_draws(jax.random.split(js.key)[1], 16)
    js, jm = jtrainer.main_stage_step(
        js, jorbit(**CAM), jnp.asarray(gt), JCFG_D,
        {k: jnp.float32(v) for k, v in sched.items()})
    ts, tm = ttrainer.main_stage_step(ts, orbit_camera(**CAM, device="cpu"),
                                      T(gt), CFG_D, sched, arap_draws=draws)
    _compare_groups(ts, tm, js, jm, "gauss", "main dense", SCHED["xyz_lr"],
                    SCHED["deform_lr"])
    assert int(tm["alive"]) == int(jm["alive"])


