"""Port parity, the deform types and DQB skinning: the dual-quaternion
utilities, the DQB node warp, ``apply_deform_field`` for node, mlp, hash
and static, two ``main_stage_step``s of a hash and an mlp model, the
Trainer's single-stage schedule for each type against the JAX trainer's,
d2dgs_torch against d2dgs_tpu with the JAX weights and state carried
across; and the cases of tests/test_eval_deform_variants.py:28-88 and
tests/test_deform_types_train.py run against the port (the training
runs under ``slow``).

Tolerances: forward values rtol 1e-5 / atol 1e-6 (the same float32
operations; DQB normalises sums of products, so 1e-6 absolute);
gradients max-normalised per array at the JAX package's kernel-gradient
tolerance (rtol 2e-4, atol 2e-5, tests/test_pallas_blend.py); a step's
state at tests/test_torch_train.py's STEP tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.models import deform as jdeform
from d2dgs_tpu.models import nodes as jnodes
from d2dgs_tpu.models.deform_mlp import MLPConfig as JMLPConfig
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_tpu.utils import dual_quaternion as jdq
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import make_video_dataset
from d2dgs_torch.io.from_jax import train_state_from_jax_arrays
from d2dgs_torch.models import deform as tdeform
from d2dgs_torch.models import nodes as tnodes
from d2dgs_torch.models.deform_mlp import MLPConfig, mlp_from_arrays
from d2dgs_torch.models.hash_deform import HashConfig
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.train.config import TrainConfig
from d2dgs_torch.utils import dual_quaternion as tdq
from test_torch_train import (SCHED, _compare_step, _flat, _gt, _leaves,
                              close_normalised)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ dual quaternions

def _dq_inputs(seed=0, n=64, k=3):
    rs = np.random.RandomState(seed)
    q = rs.normal(size=(n, k, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rs.normal(size=(n, k, 3)).astype(np.float32)
    w = rs.uniform(0.05, 1.0, size=(n, k)).astype(np.float32)
    # antipodal copies: the same rotation as the pivot with the other sign
    q[:16, 1] = -q[:16, 0]
    # tied weights: the first maximum is the pivot
    w[16:32] = 1.0
    w[32:40, 1:] = 2.0
    w /= w.sum(-1, keepdims=True)
    return q, t, w


def test_dq_utilities_parity():
    q, t, w = _dq_inputs()
    jr, jd = jdq.rigid_to_dq(jnp.asarray(q), jnp.asarray(t))
    tr, td = tdq.rigid_to_dq(T(q), T(t))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    jq2, jt2 = jdq.dq_to_rigid(jr, jd)
    tq2, tt2 = tdq.dq_to_rigid(tr, td)
    np.testing.assert_allclose(tq2.numpy(), np.asarray(jq2), **TOL)
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt2), **TOL)
    np.testing.assert_allclose(tt2.numpy(), t, rtol=1e-5, atol=1e-5)
    v = np.random.RandomState(1).normal(size=(64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tdq.quat_apply(T(q), T(v)).numpy(),
                               np.asarray(jdq.quat_apply(jnp.asarray(q),
                                                         jnp.asarray(v))),
                               **TOL)


def test_dq_blend_parity_antipodal_and_ties():
    q, t, w = _dq_inputs()
    jq, jt = jdq.dq_blend(jnp.asarray(q), jnp.asarray(t), jnp.asarray(w))
    tq, tt = tdq.dq_blend(T(q), T(t), T(w))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    # the pivot of tied weights is the first maximum in both packages
    assert (torch.argmax(T(w[16:40]), -1).numpy()
            == np.asarray(jnp.argmax(jnp.asarray(w[16:40]), -1))).all()
    # antipodal rows: flipped, not cancelled (unit blended rotation)
    np.testing.assert_allclose(np.linalg.norm(tq.numpy()[:16], axis=-1),
                               1.0, atol=1e-5)


def test_dq_sign_flip_is_strict():
    """A dq orthogonal to the pivot (dot exactly 0) keeps its sign."""
    q = np.array([[[1, 0, 0, 0], [0, 1, 0, 0]]], np.float32)
    t = np.zeros((1, 2, 3), np.float32)
    w = np.array([[0.75, 0.25]], np.float32)
    tq, _ = tdq.dq_blend(T(q), T(t), T(w))
    jq, _ = jdq.dq_blend(jnp.asarray(q), jnp.asarray(t), jnp.asarray(w))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    assert float(tq[0, 1]) > 0


def test_dqb_rigid_exactness():
    """DQB of K identical rigid transforms reproduces that transform
    (tests/test_eval_deform_variants.py:75-88 on the port)."""
    q = torch.tensor([[0.9238795, 0.0, 0.3826834, 0.0]])
    t = torch.tensor([[0.3, -0.2, 0.1]])
    N, K = 8, 3
    qb, tb = tdq.dq_blend(q[:, None].expand(N, K, 4),
                          t[:, None].expand(N, K, 3),
                          torch.full((N, K), 1.0 / K))
    x = torch.randn((N, 3), generator=torch.Generator().manual_seed(2))
    got = tdq.quat_apply(qb, x) + tb
    want = tdq.quat_apply(q.expand(N, 4), x) + t
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ----------------------------------------------------- the DQB warp

JNODE = jnodes.NodeConfig(node_num=16, K=3, hyper_dim=2,
                          mlp=JMLPConfig(is_blender=True, width=32, depth=3,
                                         local_frame=True))
HEADS = {"warp": 1e3, "rotation": 1e3, "scaling": 1e6,
         "local_rotation": 3e3}


def _node_params(jcfg, seed=1, scale=True):
    rs = np.random.RandomState(seed)
    xyz = rs.normal(size=(48, 3)).astype(np.float32)
    jp = jdeform.init_deform(jax.random.PRNGKey(seed),
                             jdeform.DeformConfig(deform_type="node",
                                                  node=jcfg),
                             init_pcl=jnp.asarray(xyz))
    mlp = jax.tree.map(np.asarray, jp.mlp)
    if scale:
        for h, f in HEADS.items():
            if h in mlp:
                mlp[h]["w"] = mlp[h]["w"] * np.float32(f)
    jp = dataclasses.replace(jp, mlp=jax.tree.map(jnp.asarray, mlp),
                             nodes=jp.nodes.at[:, 3:].set(
                                 jnp.asarray(rs.normal(
                                     size=(16, 2)).astype(np.float32)
                                     * 0.05)))
    tp = tnodes.NodeParams(T(jp.nodes), T(jp.node_radius),
                           T(jp.node_weight), mlp_from_arrays(mlp, "cpu"),
                           T(jp.alive))
    return xyz, jp, tp


def _port_node_cfg(jcfg, **kw):
    return tnodes.NodeConfig(**{
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(jcfg) if f.name != "mlp"},
        "mlp": MLPConfig(**dataclasses.asdict(jcfg.mlp)), **kw})


@pytest.mark.parametrize("skinning", ["dqb", "lbs"])
def test_dqb_warp_parity_with_grads(skinning):
    jcfg = dataclasses.replace(JNODE, skinning=skinning, exact_knn=True)
    tcfg = _port_node_cfg(jcfg)
    xyz, jp, tp = _node_params(jcfg)
    rs = np.random.RandomState(3)
    feat = (rs.normal(size=(48, 2)) * 0.05).astype(np.float32)
    mm = rs.uniform(size=(48, 1)).astype(np.float32)
    co = rs.normal(size=(48, 3)).astype(np.float32)

    def jloss(mlp):
        o = jnodes.warp(dataclasses.replace(jp, mlp=mlp), jcfg,
                        jnp.asarray(xyz), jnp.float32(0.35),
                        jnp.asarray(feat), jnp.asarray(mm))
        return jnp.sum(o["d_xyz"] * co) + jnp.sum(o["d_rotation"]), o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jp.mlp)
    to = tnodes.warp(tp, tcfg, T(xyz), torch.tensor(0.35), T(feat), T(mm))
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        np.testing.assert_allclose(to[k].detach().numpy(),
                                   np.asarray(jo[k]), **TOL, err_msg=k)
    assert float(to["d_xyz"].detach().abs().max()) > 1e-3
    tl = torch.sum(to["d_xyz"] * T(co)) + torch.sum(to["d_rotation"])
    names, params = zip(*tp.mlp.named_parameters())
    grads = torch.autograd.grad(tl, params, allow_unused=True)
    jflat = _flat(jg)
    for k, g in zip(names, grads):
        ref = np.asarray(jflat[k])
        if g is None:
            assert np.abs(ref).max() == 0.0, k
        else:
            close_normalised(g, ref, what=k)


def test_dqb_differs_from_lbs_under_rotation():
    """With large local rotations the two blends differ (DQB is not a
    relabelled LBS), and DQB stays finite."""
    _, jp, tp = _node_params(JNODE)
    xyz = T(np.random.RandomState(4).normal(size=(48, 3)).astype(
        np.float32))
    mm = torch.ones((48, 1))
    outs = [tnodes.warp(tp, _port_node_cfg(JNODE, skinning=s), xyz,
                        torch.tensor(0.8), None, mm)["d_xyz"]
            for s in ("lbs", "dqb")]
    assert bool(torch.isfinite(outs[1]).all())
    assert float((outs[0] - outs[1]).abs().max()) > 1e-4


def test_dqb_skinning_matches_lbs_at_identity():
    """tests/test_eval_deform_variants.py:53-72 on the port."""
    base = tnodes.NodeConfig(node_num=16, K=3, hyper_dim=0,
                             mlp=MLPConfig(is_blender=True, width=32,
                                           depth=2, local_frame=True))
    xyz = torch.randn((64, 3), generator=torch.Generator().manual_seed(0))
    params = tdeform.init_deform(
        tdeform.DeformConfig(deform_type="node", node=base),
        torch.Generator().manual_seed(1), device="cpu", init_pcl=xyz)
    mm = torch.ones((64, 1))
    d1 = tnodes.warp(params, base, xyz, torch.tensor(0.5), None, mm)
    d2 = tnodes.warp(params, dataclasses.replace(base, skinning="dqb"), xyz,
                     torch.tensor(0.5), None, mm)
    assert bool(torch.isfinite(d2["d_xyz"]).all())
    np.testing.assert_allclose(d1["d_xyz"].detach().numpy(),
                               d2["d_xyz"].detach().numpy(), atol=5e-3)


def test_deform_variants_shapes():
    """tests/test_eval_deform_variants.py:28-50 on the port."""
    xyz = torch.randn((32, 3), generator=torch.Generator().manual_seed(0))
    for typ in ["node", "mlp", "static"]:
        cfg = tdeform.DeformConfig(
            deform_type=typ,
            node=tnodes.NodeConfig(node_num=8, K=3, hyper_dim=2,
                                   mlp=MLPConfig(is_blender=True, width=32,
                                                 depth=2)),
            mlp=MLPConfig(is_blender=True, width=32, depth=2))
        params = tdeform.init_deform(cfg, torch.Generator().manual_seed(1),
                                     device="cpu", init_pcl=xyz)
        d = tdeform.apply_deform_field(params, cfg, xyz, torch.tensor(0.3),
                                       feature=torch.zeros((32, 2)))
        assert d["d_xyz"].shape == (32, 3)
        assert d["d_rotation"].shape == (32, 4)
        assert d["d_scaling"].shape == (32, 2)
        assert bool(torch.isfinite(d["d_xyz"]).all())
        if typ == "static":
            assert float(d["d_xyz"].abs().max()) == 0.0


# ------------------------------------------------ the four types

TINY_HASH = dict(n_levels=4, log2_hashmap_size=10, base_resolution=4,
                 start_level=2, update_steps=10, num_layers=1, hidden=32,
                 head_width=16)


@pytest.mark.parametrize("dt", ["node", "mlp", "hash", "static"])
def test_apply_deform_field_four_types_parity(dt):
    from d2dgs_tpu.models.hash_deform import HashConfig as JHashConfig
    jmlp = JMLPConfig(is_blender=True, width=32, depth=3)
    jcfg = jdeform.DeformConfig(
        deform_type=dt, node=dataclasses.replace(JNODE, exact_knn=True),
        mlp=jmlp, hash=JHashConfig(**TINY_HASH))
    tcfg = tdeform.DeformConfig(
        deform_type=dt, node=_port_node_cfg(jcfg.node),
        mlp=MLPConfig(**dataclasses.asdict(jmlp)),
        hash=HashConfig(**TINY_HASH))
    rs = np.random.RandomState(5)
    xyz = rs.normal(size=(48, 3)).astype(np.float32)
    feat = (rs.normal(size=(48, 2)) * 0.05).astype(np.float32)
    mm = rs.uniform(size=(48, 1)).astype(np.float32)
    if dt == "node":
        _, jp, tp = _node_params(jcfg.node)
    else:
        jp = jax.tree.map(np.asarray, jdeform.init_deform(
            jax.random.PRNGKey(6), jcfg))
        if dt == "mlp":
            for h in ("warp", "rotation"):
                jp[h]["w"] = jp[h]["w"] * np.float32(1e3)
        elif dt == "hash":
            jp["tables"] = [t * np.float32(1e4) for t in jp["tables"]]
            jp["mlp"][-1]["w"] = jp["mlp"][-1]["w"] * np.float32(1e4)
        tp = mlp_from_arrays(jp, "cpu")
        jp = jax.tree.map(jnp.asarray, jp)
    jo = jdeform.apply_deform_field(jp, jcfg, jnp.asarray(xyz),
                                    jnp.float32(0.6), feature=jnp.asarray(
                                        feat), motion_mask=jnp.asarray(mm),
                                    step=4_000)
    to = tdeform.apply_deform_field(tp, tcfg, T(xyz), torch.tensor(0.6),
                                    feature=T(feat), motion_mask=T(mm),
                                    step=4_000)
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        np.testing.assert_allclose(to[k].detach().numpy(),
                                   np.asarray(jo[k]), **TOL,
                                   err_msg=f"{dt} {k}")
    if dt != "static":
        assert float(to["d_xyz"].detach().abs().max()) > 1e-3, dt


# ------------------------------------------- two main-stage steps

def _jax_typed_state(dt):
    """A JAX TrainState of deform type ``dt`` on a non-trivial scene
    (random opacities, anisotropic scales and rotations, SH band 1), its
    field raised from the near-identity init so the Gaussians move."""
    jcfg = JTrainConfig(deform_type=dt, sh_degree=1, hyper_dim=2,
                        node_num=16, gaussian_capacity=256,
                        node_gauss_capacity=128, warm_up=0,
                        raster=JRasterConfig(tile_cap=256, chunk=64,
                                             pair_cap=1024,
                                             emission_cap=1 << 14,
                                             use_pallas=False))
    rs = np.random.RandomState(0)
    pts = (rs.normal(size=(128, 3)) * 0.5).astype(np.float32)
    cols = rs.uniform(size=(128, 3)).astype(np.float32)
    st = jtrainer.init_train_state(jax.random.PRNGKey(1), jcfg, pts, cols)
    g = st.gauss
    cap = g.capacity
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    g = dataclasses.replace(
        g, opacity=f32(rs.normal(size=(cap, 1)) + 1.0),
        scaling=f32(np.log(np.exp(rs.normal(size=(cap, 2)) * 0.3) * 0.08)),
        rotation=f32(rs.normal(size=(cap, 4)) + [1.0, 0, 0, 0]),
        features_rest=f32(rs.normal(size=g.features_rest.shape) * 0.1),
        active_sh_degree=jnp.int32(1))
    mlp = jax.tree.map(np.asarray, st.nodes.mlp)
    if dt == "mlp":
        for h, f in {"warp": 1e3, "rotation": 1e3, "scaling": 1e6}.items():
            mlp[h]["w"] = mlp[h]["w"] * np.float32(f)
    else:
        mlp["tables"] = [t * np.float32(1e3) for t in mlp["tables"]]
        mlp["mlp"][-1]["w"] = mlp["mlp"][-1]["w"] * np.float32(1e3)
    nodes = dataclasses.replace(st.nodes, mlp=jax.tree.map(jnp.asarray,
                                                           mlp))
    cfg = TrainConfig(deform_type=dt, sh_degree=1, hyper_dim=2, node_num=16,
                      gaussian_capacity=256, node_gauss_capacity=128,
                      warm_up=0)
    return jcfg, cfg, st._replace(gauss=g, nodes=nodes)


@pytest.mark.parametrize("dt", ["hash", "mlp"])
def test_main_stage_step_two_steps_match_jax(dt):
    """Two main-stage steps of a hash and an mlp model from the same
    carried-across TrainState (the second from the JAX state after the
    first), at step 3,500 of the hash field's band mask: the metrics, the
    three Adam groups and the densify statistics (as
    tests/test_torch_train.py's node-type test holds them).  Neither
    type has an ARAP term, so no draws are passed.  The distortion term
    is off: its float32 noise at lambda 1000 (ROADMAP.md §3, held by the
    node-type test) sums over every Gaussian into the fields' shared
    scaling head, whose second-step moment then differs by 2.1e-3 of its
    largest entry (6e-5 without the term)."""
    jcfg, cfg, js = _jax_typed_state(dt)
    gt = _gt()
    cam = dict(azimuth=0.3, elevation=0.2, radius=3.0, fov=0.8, H=32, W=32,
               time=0.4)
    sched = dict(SCHED, lambda_dist=0.0)
    sched_j = {k: jnp.float32(v) for k, v in sched.items()}
    sched_j.update(warm=jnp.float32(0.0), step=jnp.float32(3_500))
    sched_t = dict(sched, warm=0.0, step=3_500)
    jcam, tcam = jorbit(**cam), orbit_camera(**cam, device="cpu")
    for step in range(2):
        ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
        js, jm = jtrainer.main_stage_step(js, jcam, jnp.asarray(gt), jcfg,
                                          sched_j)
        ts, tm = ttrainer.main_stage_step(ts, tcam, T(gt), cfg, sched_t)
        _compare_step(ts, tm, js, jm, f"{dt} step {step + 1}")
        moved = sum(float(v.abs().max()) for v in ts.mlp_opt.mu.values())
        assert moved > 0, dt
    if dt == "hash":
        # at step 3,500 of 6,000 the band has opened features 12-18;
        # levels 10 and 11 (features 20-23) get no gradient
        for lvl in (10, 11):
            assert float(ts.mlp_opt.mu[f"tables.{lvl}"].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["hash", "mlp"])
def test_main_stage_step_empty_view_matches_jax(dt):
    """A view where nothing is drawn (every Gaussian dead) with a field
    type, which has no ARAP term: the loss is the background's against
    the target in both packages and every gradient is zero, so no
    parameter moves and the Adam counts advance.  The port's loss then
    has no graph on the plain path; its step used to raise there."""
    jcfg, cfg, js = _jax_typed_state(dt)
    js = js._replace(gauss=dataclasses.replace(
        js.gauss, alive=jnp.zeros_like(js.gauss.alive)))
    ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
    groups = lambda st: {**ttrainer.gauss_trainable(st.gauss),
                         **ttrainer.mlp_trainable(st.nodes)}
    before = {k: v.detach().clone() for k, v in groups(ts).items()}
    cam = dict(azimuth=0.3, elevation=0.2, radius=3.0, fov=0.8, H=32, W=32,
               time=0.4)
    sched_j = {k: jnp.float32(v) for k, v in SCHED.items()}
    sched_j["warm"] = jnp.float32(0.0)
    js2, jm = jtrainer.main_stage_step(js, jorbit(**cam), jnp.asarray(_gt()),
                                       jcfg, sched_j)
    ts, tm = ttrainer.main_stage_step(ts, orbit_camera(**cam, device="cpu"),
                                      T(_gt()), cfg, dict(SCHED, warm=0.0))
    assert int(tm["num_pairs"]) == int(jm["num_pairs"]) == 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    for k, v in groups(ts).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert int(ts.mlp_opt.count) == int(js2.mlp_opt.count) == 1


# ----------------------------------- the Trainer's single-stage schedule

SCHEDULE = dict(node_warm_up=4, iterations_node_sampling=12,
                iterations_node_rendering=15, iterations=14, warm_up=3,
                densification_interval=5, densify_from_iter=2,
                opacity_reset_interval=6, oneup_sh_degree_step=4,
                node_force_densify_prune_step=7, densify_until_iter=13,
                normal_dist_from_iter=5)


@pytest.mark.parametrize("dt", ["mlp", "hash", "static"])
def test_trainer_single_stage_schedule_matches_jax(monkeypatch, dt):
    """Both Trainers of a non-node type, every step function replaced by a
    recorder that leaves the state alone: no stage-1 call, no node
    densify, and the same (call, iteration, camera, time) sequence."""
    jcfg = JTrainConfig(deform_type=dt, sh_degree=1, hyper_dim=2,
                        node_num=8, gaussian_capacity=512,
                        node_gauss_capacity=32,
                        raster=JRasterConfig(use_pallas=False), **SCHEDULE)
    tcfg = TrainConfig(deform_type=dt, sh_degree=1, hyper_dim=2, node_num=8,
                       gaussian_capacity=512, node_gauss_capacity=32,
                       **SCHEDULE)
    cams, imgs, pts, cols = make_video_dataset(0, n_cams=3, n_times=2, H=16,
                                               W=16, n_gauss=8, device="cpu")
    jcams = [jorbit(0.0, 0.3, 4.0, fov=0.9, H=16, W=16, time=float(c.time))
             for c in cams]

    def run(mod, cfg, cameras):
        log = []
        tr = mod.Trainer(cfg, cameras, imgs, pts, cols, cameras_extent=4.0,
                         seed=3, **({} if mod is jtrainer else
                                    {"device": "cpu"}))
        assert tr.total_iterations() == cfg.iterations
        assert tr.iteration_node == cfg.iterations_node_rendering

        def recorder(name, returns_info, camera_arg):
            def fn(state, *a, **k):
                entry = [name, tr.iteration]
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
                ("node_densify_step", True, False),
                ("oneup_sh", False, False)):
            monkeypatch.setattr(mod, name, recorder(name, info, cam))
        tr.train()
        return log

    jlog = run(jtrainer, jcfg, jcams)
    tlog = run(ttrainer, tcfg, cams)
    assert tlog == jlog
    assert {e[0] for e in tlog} == {"main_stage_step", "densify_step",
                                    "reset_opacity_step", "oneup_sh"}
    assert sum(e[0] == "main_stage_step" for e in tlog) == 14


# ------------------- tests/test_deform_types_train.py on the port (slow)

def _train_cfg(dt, **kw):
    base = dict(
        deform_type=dt, gaussian_capacity=256, node_gauss_capacity=64,
        node_num=16, iterations=6, warm_up=2, node_warm_up=2,
        iterations_node_sampling=3, iterations_node_rendering=4,
        densify_from_iter=100, densify_until_iter=0,
        raster=RasterConfig(tile_cap=128, chunk=64))
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def scene():
    return make_video_dataset(0, n_cams=2, n_times=2, H=32, W=32,
                              n_gauss=8, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("dt", ["node", "mlp", "hash", "hexplane", "static"])
def test_deform_type_trains(scene, dt):
    cams, imgs, pts, cols = scene
    tr = ttrainer.Trainer(_train_cfg(dt), cams, imgs, pts[:32], cols[:32],
                          cameras_extent=4.0, seed=0, device="cpu")
    assert tr.total_iterations() == (6 + 4 if dt == "node" else 6)
    losses = []
    for _ in range(tr.total_iterations()):
        m = tr.step()
        if m:
            losses.append(float(m["loss"]))
    assert len(losses) >= 6
    assert np.isfinite(losses).all()
    if dt != "static":    # static can't fit a moving scene
        assert losses[-1] < losses[0]
    if dt in ("mlp", "hash", "hexplane"):
        assert any(float(p.abs().max()) > 0
                   for p in tr.state.nodes.mlp.parameters())


def test_trainer_passes_step(scene):
    """An mlp model with progressive_band_time deforms otherwise at step 0
    than at step 1e9: the step reaches the field."""
    cams, imgs, pts, cols = scene
    cfg = _train_cfg("mlp", progressive_band_time=True, warm_up=0)
    tr = ttrainer.Trainer(cfg, cams, imgs, pts[:32], cols[:32],
                          cameras_extent=4.0, seed=0, device="cpu")
    g = tr.state.gauss
    d_early, d_late = (tdeform.deform_gaussians(
        tr.state.nodes, cfg.deform_cfg, g, torch.tensor(0.5), step=s)
        for s in (0, 10**9))
    assert float((d_early["d_xyz"] - d_late["d_xyz"]).abs().max()) > 0
