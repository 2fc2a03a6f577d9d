"""Port parity, the optical-flow training path: the RAFT file loader
(d2dgs_torch/data/flow.py), ``render_flow``, ``optical_flow_loss``, a
main-stage step with the flow term and the Trainer's flow picks, against
d2dgs_tpu on the same inputs (a JAX TrainState carried across by
d2dgs_torch.io.from_jax; the JAX side's blend runs its Pallas kernels in
interpret mode, its 3DGS blend is XLA).

Tolerances: the loader bitwise; render_flow as the 3DGS rasterizer's
parity (tests/test_torch_raster3d.py: image and alpha 2e-5, depth 2e-4,
radii bitwise); the flow loss to 1e-5 relative and its gradients
max-normalised to 2e-4 (the repo's gradient tolerance); two flow steps as
test_torch_train's two-step test (moments max-normalised to 1e-3)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data import flow as jflow
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.data.synthetic import make_video_dataset as jvideo
from d2dgs_tpu.models.deform import deform_gaussians as jdeform
from d2dgs_tpu.render.renderer import render_flow as jrender_flow
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_torch.data import flow as tflow
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import make_video_dataset as tvideo
from d2dgs_torch.data.synthetic import write_flow_file
from d2dgs_torch.io.from_jax import train_state_from_jax_arrays
from d2dgs_torch.models.deform import apply_deform_field as tdeform
from d2dgs_torch.render.renderer import render_flow
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.train.config import TrainConfig
from test_torch_train import (CAM, CFG, JCFG, SCHED, STEP, T, _arap_draws,
                              _compare_step, _gt, _jax_state, _leaves,
                              close_normalised)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

CAM2 = dict(CAM, time=0.7)


@pytest.fixture(scope="module")
def jstate():
    return _jax_state()


def _flow_target(seed=11, H=32, W=32):
    rs = np.random.RandomState(seed)
    gt_flow = (rs.normal(size=(H, W, 2)) * 0.05).astype(np.float32)
    mask = (rs.uniform(size=(H, W, 1)) > 0.2).astype(np.float32)
    return gt_flow, mask


# ---------------------------------------------------------- the loader

@pytest.mark.parametrize("hw", [(16, 24), (32, 48)], ids=["same", "resize"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_load_flow_and_target_name_bitwise(tmp_path, hw, with_mask):
    """The same RAFT files through both loaders: flow and mask bitwise,
    with the resize (values scaled by the size ratio) when the images
    are larger than the files."""
    rs = np.random.RandomState(1)
    flow = (rs.normal(size=(16, 24, 2)) * 3).astype(np.float32)
    mask = (rs.uniform(size=(16, 24, 2)) > 0.6) if with_mask else None
    path = write_flow_file(str(tmp_path), "f003", "f004", flow, mask)
    assert tflow.target_name(path) == jflow.target_name(path) == "f004"
    H, W = hw
    tf, tm = tflow.load_flow(path, H, W)
    jf, jm = jflow.load_flow(path, H, W)
    assert tf.dtype == jf.dtype and tm.dtype == jm.dtype
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm, jm)
    assert tf.shape == (H, W, 2) and tm.shape == (H, W, 1)
    if not with_mask:
        assert tm.min() == 1.0
    if hw == (16, 24):
        np.testing.assert_allclose(tf, flow / np.array([24, 16]) * 2,
                                   rtol=1e-6)
    # names as the JAX package parses them: after the last underscore
    assert tflow.target_name("/x/raft_neighbouring/r_000.to_r_001.npy") \
        == jflow.target_name("/x/raft_neighbouring/r_000.to_r_001.npy") \
        == "001"


# --------------------------------------------------------- render_flow

@pytest.mark.parametrize("scale_const", [None, 0.02])
def test_render_flow_matches_jax(jstate, scale_const):
    """From a carried-across model, with the warp's d_xyz, d_rotation and
    d_scaling at two times, and with scale_const."""
    js = jstate
    ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
    jc1, jc2 = jorbit(**CAM), jorbit(**CAM2)
    tc1, tc2 = orbit_camera(**CAM, device="cpu"), orbit_camera(
        **CAM2, device="cpu")
    g = js.gauss
    jd1 = jdeform(js.nodes, JCFG.deform_cfg, g.xyz, jc1.time,
                  feature=g.feature, motion_mask=g.motion_mask)
    jd2 = jdeform(js.nodes, JCFG.deform_cfg, g.xyz, jc2.time,
                  feature=g.feature, motion_mask=g.motion_mask)
    j = jrender_flow(g, jc1, jc2, jd1["d_xyz"], jd2["d_xyz"],
                     d_rotation1=jd1["d_rotation"],
                     d_scaling1=jd1["d_scaling"], scale_const=scale_const,
                     cfg=JCFG.raster)
    tg = ts.gauss
    with torch.no_grad():
        td1 = tdeform(ts.nodes, CFG.deform_cfg, tg.xyz, tc1.time,
                      feature=tg.feature, motion_mask=tg.motion_mask)
        td2 = tdeform(ts.nodes, CFG.deform_cfg, tg.xyz, tc2.time,
                      feature=tg.feature, motion_mask=tg.motion_mask)
        t = render_flow(tg, tc1, tc2, td1["d_xyz"], td2["d_xyz"],
                        d_rotation1=td1["d_rotation"],
                        d_scaling1=td1["d_scaling"],
                        scale_const=scale_const, cfg=CFG.raster)
    assert float(np.abs(np.asarray(jd1["d_rotation"])).max()) > 1e-3
    np.testing.assert_array_equal(t["radii"].numpy(), np.asarray(j["radii"]))
    np.testing.assert_array_equal(t["visibility_filter"].numpy(),
                                  np.asarray(j["visibility_filter"]))
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]),
                               atol=2e-5)
    np.testing.assert_allclose(t["alpha"].numpy(), np.asarray(j["alpha"]),
                               atol=2e-5)
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]),
                               atol=2e-4)
    # the uv flow is not zero where the scene is covered
    assert float(t["render"][..., :2].abs().max()) > 1e-3
    # the same deformation at both ends: no uv flow (the JAX contract)
    same = render_flow(tg, tc1, None, td1["d_xyz"], td1["d_xyz"],
                       cfg=CFG.raster)
    np.testing.assert_allclose(same["render"][..., :2].detach().numpy(),
                               0.0, atol=1e-6)


# ----------------------------------------------------- the flow loss

def test_optical_flow_loss_value_and_gradients(jstate):
    js = jstate
    ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
    jc1, jc2 = jorbit(**CAM), jorbit(**CAM2)
    tc1, tc2 = orbit_camera(**CAM, device="cpu"), orbit_camera(
        **CAM2, device="cpu")
    gt_flow, mask = _flow_target()
    gt = _gt()
    image = np.clip(gt + np.random.RandomState(12).normal(
        size=gt.shape) * 0.2, 0, 1).astype(np.float32)
    sched = {"step": 100.0}

    def jloss(g_train, mlp):
        g = jtrainer.with_trainable(js.gauss, g_train)
        nodes = dataclasses.replace(js.nodes, mlp=mlp)
        return jtrainer.optical_flow_loss(
            g, nodes, jc1, jc2, jnp.asarray(gt_flow), jnp.asarray(mask),
            jnp.float32(0.8), jnp.asarray(image), jnp.asarray(gt), JCFG,
            sched)

    jval, (jg, jm) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jtrainer.gauss_trainable(js.gauss), js.nodes.mlp)
    tval = ttrainer.optical_flow_loss(
        ts.gauss, ts.nodes, tc1, tc2, T(gt_flow), T(mask), 0.8, T(image),
        T(gt), CFG, sched)
    assert float(jval) > 0
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    tg = ttrainer.gauss_trainable(ts.gauss)
    tm = ttrainer.mlp_trainable(ts.nodes)
    grads = torch.autograd.grad(tval, list(tg.values()) + list(tm.values()),
                                allow_unused=True)
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(jm)[0]}
    ref = dict(jg, **flat)
    moved = 0
    for name, g in zip(list(tg) + list(tm), grads):
        r = np.asarray(ref[name])
        if g is None:
            assert np.abs(r).max() == 0, name
            continue
        if np.abs(r).max() > 0:
            moved += 1
        close_normalised(g, r, what=name)
    assert moved >= 4         # xyz, scaling, rotation, opacity, the MLP


def test_main_stage_step_flow_term_two_steps_match_jax(jstate):
    """Two main-stage steps with lambda_optical 0.1, each from the same
    carried-across TrainState in both packages."""
    gt_flow, mask = _flow_target()
    sched = dict(SCHED, warm=0.0, lambda_optical=0.1)
    sched_j = {k: jnp.float32(v) for k, v in sched.items()}
    jc1, jc2 = jorbit(**CAM), jorbit(**CAM2)
    tc1, tc2 = orbit_camera(**CAM, device="cpu"), orbit_camera(
        **CAM2, device="cpu")
    js = jstate
    for step in range(2):
        ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
        draws = _arap_draws(jax.random.split(js.key)[1], 16)
        js, jm = jtrainer.main_stage_step(
            js, jc1, jnp.asarray(_gt()), JCFG, sched_j,
            flow_sample=(jc2, jnp.asarray(gt_flow), jnp.asarray(mask),
                         jnp.float32(0.8)), flow_loss=True)
        ts, tm = ttrainer.main_stage_step(
            ts, tc1, T(_gt()), CFG, sched,
            flow_sample=(tc2, T(gt_flow), T(mask), 0.8), flow_loss=True,
            arap_draws=draws)
        _compare_step(ts, tm, js, jm, f"flow step {step + 1}")


# ------------------------------------------------------ the Trainer

def _flow_scene(tmp_path, n_cams=2, n_times=3, H=24, W=24):
    """Both packages' synthetic video and RAFT files between its frames,
    named so their targets resolve, plus a file whose target is not a
    training frame and one that cannot be read."""
    jv = jvideo(jax.random.PRNGKey(3), n_cams=n_cams, n_times=n_times, H=H,
                W=W, n_gauss=8)
    tv = tvideo(3, n_cams=n_cams, n_times=n_times, H=H, W=W, n_gauss=8,
                device="cpu")
    n = len(jv[0])
    names = [f"f{i:03d}.png" for i in range(n)]
    rs = np.random.RandomState(4)
    root = str(tmp_path)
    for i in range(n):
        for j in ((i + 1) % n, (i + 2) % n):
            hw = (H, W) if j % 2 else (H // 2, W // 2)
            write_flow_file(root, f"f{i:03d}", f"f{j:03d}",
                            rs.normal(size=hw + (2,)).astype(np.float32),
                            rs.uniform(size=hw + (2,)) > 0.3)
    write_flow_file(root, "f000", "f999", np.zeros((H, W, 2), np.float32))
    with open(os.path.join(root, "raft_neighbouring", "f001.bad_f004.npy"),
              "w") as fh:
        fh.write("not a numpy file")

    class S:
        def __init__(self, name):
            self.image_name = name
    dirs = tflow.find_flow_dirs(root, [S(nm) for nm in names])
    assert dirs == jflow.find_flow_dirs(root, [S(nm) for nm in names])
    return jv, tv, names, dirs


def test_trainers_pick_the_same_flow_samples(tmp_path):
    jv, tv, names, dirs = _flow_scene(tmp_path)
    kw = dict(sh_degree=1, hyper_dim=2, node_num=16,
              gaussian_capacity=256, node_gauss_capacity=64)
    jtr = jtrainer.Trainer(JTrainConfig(**kw), *jv, cameras_extent=4.0,
                           seed=5, flow_dirs=dirs, image_names=names)
    ttr = ttrainer.Trainer(TrainConfig(**kw), *tv, cameras_extent=4.0,
                           seed=5, flow_dirs=dirs, image_names=names,
                           device="cpu")
    picked = none = 0
    for _ in range(30):
        jtr._pick_camera()
        ttr._pick_camera()
        assert jtr._last_cam_idx == ttr._last_cam_idx
        jf = jtr._pick_flow_sample(jtr._last_cam_idx)
        tf = ttr._pick_flow_sample(ttr._last_cam_idx)
        assert (jf is None) == (tf is None)
        if jf is None:
            none += 1
            continue
        picked += 1
        assert float(jf[0].time) == float(tf[0].time)
        np.testing.assert_array_equal(tf[1].numpy(), np.asarray(jf[1]))
        np.testing.assert_array_equal(tf[2].numpy(), np.asarray(jf[2]))
        # the JAX trainer hands the weight over as float32
        assert np.float32(tf[3]) == np.asarray(jf[3])
    assert picked > 5 and none > 0
    assert str(jtr.rng.get_state()) == str(ttr.rng.get_state())


def test_trainer_main_iteration_takes_flow_steps(tmp_path):
    """The landmark gate: no flow before the warm-up ends, then a flow
    sample on every step whose camera has a resolvable file."""
    _, tv, names, dirs = _flow_scene(tmp_path)
    cfg = TrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                      gaussian_capacity=256, node_gauss_capacity=64,
                      warm_up=3, iterations_node_rendering=1,
                      densify_from_iter=1000, oneup_sh_degree_step=1000,
                      node_force_densify_prune_step=1000)
    tr = ttrainer.Trainer(cfg, *tv, cameras_extent=4.0, seed=0,
                          flow_dirs=dirs, image_names=names, device="cpu")
    flow = []
    for _ in range(8):
        m = tr.step()
        flow.append("lambda_optical" in m)
        assert np.isfinite(float(m["loss"]))
    assert not any(flow[:2]) and sum(flow[2:]) >= 3
