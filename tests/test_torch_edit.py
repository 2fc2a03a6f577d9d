"""Port parity, the editing stack: bezier trajectories, the ARAP graph and
deformer, LapDeform, DeformKeypoints, p2dR and warp_with_bias of
d2dgs_torch against d2dgs_tpu on seeded numpy inputs (the JAX weights
carried across), the cases of tests/test_edit.py and
tests/test_p2dr_and_anneal.py:37-68 run against the port, and
``cli edit --device cpu`` against the JAX ``cli edit`` on one tiny
checkpoint.

Tolerances: bezier and the graph's weights 1e-5 relative / 1e-6
absolute (the same float32 operations); positions through the dense
solve 1e-4 / 1e-5 and energies 1e-4 relative (the solve and the SVD
come from different LAPACK builds); rotations 1e-4 (an SVD of float32
covariances).  The
clouds are non-degenerate: a rank-deficient covariance makes the sign of
a singular vector, so p2dR's rotation (no det fix), depend on the
LAPACK (ROADMAP.md, "Parity traps")."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.edit import arap as jarap
from d2dgs_tpu.edit import DeformKeypoints as JKeypoints
from d2dgs_tpu.edit import LapDeform as JLapDeform
from d2dgs_tpu.models import nodes as jnodes
from d2dgs_tpu.models.deform_mlp import MLPConfig as JMLPConfig
from d2dgs_tpu.utils import bezier as jbezier
from d2dgs_torch.edit import arap as tarap
from d2dgs_torch.edit import DeformKeypoints, LapDeform
from d2dgs_torch.models import nodes as tnodes
from d2dgs_torch.models.deform_mlp import MLPConfig, mlp_from_arrays
from d2dgs_torch.utils import bezier as tbezier
from d2dgs_torch.utils.quaternion import quat_to_rotmat, rotmat_to_quat

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

POS = dict(rtol=1e-5, atol=1e-6)
ROT = dict(rtol=1e-4, atol=1e-4)


def T(a):
    return torch.from_numpy(np.array(a))


def _grid_cloud(n=5, spacing=0.2):
    g = np.arange(n) * spacing
    pts = np.stack(np.meshgrid(g, g, [0.0], indexing="ij"), -1)
    return pts.reshape(-1, 3).astype(np.float32)


def _cloud(n=64, seed=0):
    """A non-degenerate 3-D cloud: every KNN neighbourhood spans 3-D."""
    return np.random.RandomState(seed).normal(size=(n, 3)).astype(
        np.float32)


# ------------------------------------------------------------- bezier

def test_bezier_parity():
    rs = np.random.RandomState(0)
    ctrl = rs.normal(size=(5, 3)).astype(np.float32)
    ts = np.linspace(0, 1, 11).astype(np.float32)
    np.testing.assert_allclose(
        tbezier.de_casteljau(T(ctrl), T(ts)).numpy(),
        np.asarray(jbezier.de_casteljau(jnp.asarray(ctrl), ts)), **POS)
    np.testing.assert_allclose(
        tbezier.de_casteljau(T(ctrl), 0.3).numpy(),
        np.asarray(jbezier.de_casteljau(jnp.asarray(ctrl), 0.3)), **POS)
    for k in (1, 2, 3, 6):
        kp = rs.normal(size=(k, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tbezier.bezier_trajectory(kp, ts).numpy(),
            np.asarray(jbezier.bezier_trajectory(kp, ts)), **POS,
            err_msg=f"{k} keypoints")
    # the CLI's drag: start, arc, end
    drag = np.stack([np.zeros(3), [0.1, 0.3, 0], [0.4, 0, 0.2]]).astype(
        np.float32)
    got = tbezier.bezier_trajectory(drag, np.linspace(0, 1, 8)).numpy()
    np.testing.assert_allclose(got[[0, -1]], drag[[0, -1]], atol=1e-7)


# ---------------------------------------------------------- the graph

@pytest.mark.parametrize("radius", [None, 0.3])
def test_build_graph_parity(radius):
    pcl = _cloud(48, seed=1)
    j = jarap.build_graph(jnp.asarray(pcl), K=4, radius=radius)
    t = tarap.build_graph(T(pcl), K=4, radius=radius)
    np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr))
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), **POS)
    np.testing.assert_allclose(t.L.numpy(), np.asarray(j.L), **POS)


def _handles(n, idx, pos):
    mask = np.zeros(n, bool)
    mask[idx] = True
    hp = np.zeros((n, 3), np.float32)
    hp[idx] = pos
    return mask, hp


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_arap_deform_and_energy_parity(n_iters):
    pcl = _cloud(48, seed=2)
    rs = np.random.RandomState(3)
    idx = np.array([0, 5, 11, 17, 30, 41])
    target = pcl[idx] + rs.normal(size=(6, 3)).astype(np.float32) * 0.3
    mask, hp = _handles(48, idx, target)
    jg = jarap.build_graph(jnp.asarray(pcl), K=4)
    tg = tarap.build_graph(T(pcl), K=4)
    jp, jq = jarap.arap_deform(jg, jnp.asarray(mask), jnp.asarray(hp),
                               n_iters=n_iters)
    tp, tq = tarap.arap_deform(tg, T(mask), T(hp), n_iters=n_iters)
    assert bool(torch.isfinite(tp).all())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tp.numpy()[idx], target, atol=1e-5)
    if n_iters:
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **ROT)
    e_t = float(tarap.deform_energy(tg, tp))
    e_j = float(jarap.deform_energy(jg, jp))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4)


def test_arap_closed_node_set_is_singular_in_both():
    """A node set whose nearest neighbours all lie inside it and that
    holds no handle makes the global step singular in both packages (the
    reference's trap, ROADMAP.md "Parity traps"): the same graph, a
    vanishing singular value, and solutions that agree on the handled
    cluster, whose rows never reach the free one."""
    rs = np.random.RandomState(10)
    near = rs.normal(size=(24, 3)).astype(np.float32) * 0.3
    far = rs.normal(size=(8, 3)).astype(np.float32) * 0.3 + 50.0
    pcl = np.concatenate([near, far])
    idx = np.array([0, 3, 7, 12])
    target = pcl[idx] + np.float32(0.2)
    mask, hp = _handles(32, idx, target)
    jg = jarap.build_graph(jnp.asarray(pcl), K=4)
    tg = tarap.build_graph(T(pcl), K=4)
    np.testing.assert_array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
    assert (tg.nbr.numpy()[24:] >= 24).all()       # the far set is closed
    A = np.where(mask[:, None], np.eye(32), tg.L.numpy().astype(np.float64))
    sv = np.linalg.svd(A, compute_uv=False)
    assert sv[-1] < 1e-6 * sv[0]
    jp, _ = jarap.arap_deform(jg, jnp.asarray(mask), jnp.asarray(hp),
                              n_iters=1)
    tp, _ = tarap.arap_deform(tg, T(mask), T(hp), n_iters=1)
    np.testing.assert_allclose(tp.numpy()[:24], np.asarray(jp)[:24],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.numpy()[idx], target, atol=1e-5)


def test_fit_rotations_det_fix_parity():
    """Reflected edge sets: the det < 0 fix flips the weakest singular
    direction in both packages."""
    rs = np.random.RandomState(4)
    P = rs.normal(size=(16, 4, 3)).astype(np.float32)
    refl = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    Pp = P @ refl.T + rs.normal(size=P.shape).astype(np.float32) * 0.05
    Pp[:4] = P[:4]                                  # undeformed rows
    w = rs.uniform(0.1, 1.0, size=(16, 4)).astype(np.float32)
    jR = jarap._fit_rotations(jnp.asarray(P), jnp.asarray(Pp),
                              jnp.asarray(w))
    tR = tarap._fit_rotations(T(P), T(Pp), T(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), **ROT)
    np.testing.assert_allclose(np.linalg.det(tR.numpy()), 1.0, atol=1e-4)
    np.testing.assert_array_equal(tR.numpy()[:4],
                                  np.broadcast_to(np.eye(3), (4, 3, 3)))


def test_lap_deform_parity():
    pcl = _cloud(40, seed=5)
    mask = np.ones(40, bool)
    mask[::7] = False
    j = JLapDeform(pcl, K=4, point_mask=mask)
    t = LapDeform(pcl, K=4, point_mask=mask, device="cpu")
    assert t.N == j.N
    idx = np.array([1, 9, 30])
    np.testing.assert_array_equal(t.world_2_local_index(idx),
                                  j.world_2_local_index(idx))
    np.testing.assert_array_equal(t.add_n_ring_nbs(idx, 2),
                                  j.add_n_ring_nbs(idx, 2))
    pos = pcl[idx] + np.float32(0.2)
    np.testing.assert_allclose(t.deform(idx, pos).numpy(),
                               np.asarray(j.deform(idx, pos)), rtol=1e-4,
                               atol=1e-5)
    tp, tq = t.deform_arap(idx, pos, n_iters=2)
    jp, jq = j.deform_arap(idx, pos, n_iters=2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **ROT)
    # a pose off the solve's (the solved one has a Laplacian energy of
    # float32 noise only)
    moved = np.array(jp) + np.random.RandomState(9).normal(
        size=jp.shape).astype(np.float32) * 0.05
    np.testing.assert_allclose(t.estimate_R(moved).numpy(),
                               np.asarray(j.estimate_R(moved)), **ROT)
    np.testing.assert_allclose(float(t.energy(moved)),
                               float(j.energy(moved)), rtol=1e-4)
    np.testing.assert_allclose(float(t.energy_arap(moved)),
                               float(j.energy_arap(moved)), rtol=1e-4)
    with pytest.raises(ValueError, match="mask"):
        t.world_2_local_index([7])


def test_deform_keypoints_parity():
    pcl = _cloud(20, seed=6)
    ops = [("add_kpts", ([1, 5, 7],), dict(expand=True)),
           ("add_kpts", ([5, 9],), {}), ("update_kpts", ([0.1, 0, -0.2],), {}),
           ("select_kpts", ([5, 9],), {}),
           ("update_kpts", ([0, 0.3, 0],), {}), ("delete_kpts", ([1],), {}),
           ("add_kpts", ([2, 3],), dict(expand=True)),
           ("update_kpts", ([0.05, 0.05, 0.05],), {})]
    t, j = DeformKeypoints(), JKeypoints()
    for name, a, kw in ops:
        getattr(t, name)(pcl, *a, **kw) if name == "add_kpts" else \
            getattr(t, name)(*a, **kw)
        getattr(j, name)(pcl, *a, **kw) if name == "add_kpts" else \
            getattr(j, name)(*a, **kw)
        ti, tpos = t.get_kpts()
        ji, jpos = j.get_kpts()
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tpos, jpos)
        assert t.selective_keypoints_idx == j.selective_keypoints_idx


# ------------------------------------------ p2dR and warp_with_bias

JCFG = jnodes.NodeConfig(node_num=32, K=3, hyper_dim=2,
                         mlp=JMLPConfig(depth=2, width=32, is_blender=True))
CFG = tnodes.NodeConfig(node_num=32, K=3, hyper_dim=2,
                        mlp=MLPConfig(depth=2, width=32, is_blender=True))


def _jax_params(seed=0, head_scale=1e3):
    """JAX node params from a 3-D cloud, the warp head raised so the nodes
    move with t."""
    key = jax.random.PRNGKey(seed)
    pcl = jax.random.normal(key, (64, 3))
    p = jnodes.init_node_params(key, JCFG)
    p = jnodes.init_nodes_from_pcl(p, JCFG, pcl, jax.random.PRNGKey(1))
    mlp = jax.tree.map(np.asarray, p.mlp)
    mlp["warp"]["w"] = mlp["warp"]["w"] * np.float32(head_scale)
    return dataclasses.replace(p, mlp=jax.tree.map(jnp.asarray, mlp))


def _port_params(jp):
    return tnodes.NodeParams(T(jp.nodes), T(jp.node_radius),
                             T(jp.node_weight),
                             mlp_from_arrays(jax.tree.map(np.asarray,
                                                          jp.mlp), "cpu"),
                             T(jp.alive))


def _rotmat(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def test_get_trajectory_parity():
    jp = _jax_params()
    tp = _port_params(jp)
    np.testing.assert_allclose(
        tnodes.get_trajectory(tp, CFG, 4).numpy(),
        np.asarray(jnodes.get_trajectory(jp, JCFG, 4)), **POS)


@pytest.mark.parametrize("mode", ["trajectory", "nodes"])
def test_p2dr_parity(mode):
    jp = _jax_params()
    tp = _port_params(jp)
    rs = np.random.RandomState(7)
    p0 = np.asarray(jp.nodes[:, :3])
    p = (p0 @ _rotmat([0.2, 1.0, -0.4], 0.5).T.astype(np.float32)
         + rs.normal(size=p0.shape).astype(np.float32) * 0.05)
    jq = jnodes.p2dR(jp, JCFG, p=jnp.asarray(p), p0=jnp.asarray(p0), K=8,
                     mode=mode)
    tq = tnodes.p2dR(tp, CFG, p=T(p), p0=T(p0), K=8, mode=mode)
    np.testing.assert_allclose(quat_to_rotmat(tq).numpy(),
                               np.asarray(quat_to_rotmat(T(np.asarray(jq)))),
                               **ROT)


@pytest.mark.parametrize("d_rot_as_res", [True, False])
def test_warp_with_bias_parity(d_rot_as_res):
    jcfg = dataclasses.replace(JCFG, d_rot_as_res=d_rot_as_res)
    tcfg = dataclasses.replace(CFG, d_rot_as_res=d_rot_as_res)
    jp = _jax_params()
    tp = _port_params(jp)
    rs = np.random.RandomState(8)
    x = (rs.normal(size=(40, 3)) * 0.5).astype(np.float32)
    feat = (rs.normal(size=(40, 2)) * 0.01).astype(np.float32)
    mm = rs.uniform(size=(40, 1)).astype(np.float32)
    bias = (rs.normal(size=(32, 3)) * 0.1).astype(np.float32)
    jo = jnodes.warp_with_bias(jp, jcfg, jnp.asarray(x), 0.3,
                               jnp.asarray(feat), jnp.asarray(mm),
                               node_trans_bias=jnp.asarray(bias))
    to = tnodes.warp_with_bias(tp, tcfg, T(x), 0.3, T(feat), T(mm),
                               node_trans_bias=T(bias))
    assert set(to) == set(jo)
    for k, v in to.items():
        if v is None:
            assert jo[k] is None, k
            continue
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jo[k]),
                                   **ROT, err_msg=k)


# ------------------------------------ tests/test_edit.py on the port

def test_rotmat_quat_roundtrip():
    rs = np.random.RandomState(0)
    q = rs.randn(32, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    np.testing.assert_allclose(rotmat_to_quat(quat_to_rotmat(T(q))).numpy(),
                               q, atol=1e-4)


def test_arap_rigid_translation_is_exact():
    pcl = _grid_cloud()
    lap = LapDeform(pcl, K=4, device="cpu")
    handle_idx = np.array([0, 4, 20, 24])
    delta = np.array([0.3, -0.1, 0.2], np.float32)
    new, quats = lap.deform_arap(handle_idx, pcl[handle_idx] + delta)
    np.testing.assert_allclose(new.numpy(), pcl + delta, atol=1e-3)
    np.testing.assert_allclose(quats.numpy()[:, 0], 1.0, atol=1e-3)


def test_arap_handles_pinned_and_rigidity():
    pcl = _grid_cloud()
    lap = LapDeform(pcl, K=4, device="cpu")
    handle_idx = np.array([0, 24])
    target = pcl[handle_idx].copy()
    target[1] += np.array([0.0, 0.0, 0.4], np.float32)
    new, _ = lap.deform_arap(handle_idx, target)
    new = new.numpy()
    np.testing.assert_allclose(new[handle_idx], target, atol=1e-5)
    assert np.isfinite(new).all()
    assert np.linalg.norm(new - pcl, axis=-1).max() <= 0.4 + 1e-3
    naive = pcl.copy()
    naive[handle_idx] = target
    assert float(lap.energy_arap(new)) < float(lap.energy_arap(naive))


def test_lap_deform_laplacian_editing():
    pcl = _grid_cloud()
    lap = LapDeform(pcl, K=4, device="cpu")
    new = lap.deform(np.array([12]), pcl[[12]] + [0, 0, 0.2]).numpy()
    assert abs(new[12, 2] - 0.2) < 1e-5
    assert np.isfinite(new).all()


def test_point_mask_and_rings():
    pcl = _grid_cloud()
    mask = np.zeros(len(pcl), bool)
    mask[:15] = True
    lap = LapDeform(pcl, K=3, point_mask=mask, device="cpu")
    assert lap.N == 15
    assert len(lap.add_one_ring_nbs([0])) > 1
    assert lap.world_2_local_index([3])[0] == 3


def test_deform_keypoints():
    pcl = _grid_cloud()
    kp = DeformKeypoints()
    kp.add_kpts(pcl, [1, 5, 7], expand=True)
    assert len(kp) == 3
    kp.add_kpts(pcl, [5])
    assert len(kp) == 3
    kp.update_kpts([0.1, 0.0, 0.0])
    idx, pos = kp.get_kpts()
    np.testing.assert_allclose(pos[0], pcl[1] + [0.1, 0, 0], atol=1e-6)
    kp.delete_kpts([5])
    assert len(kp) == 2


# ------------------- tests/test_p2dr_and_anneal.py:37-68 on the port

def test_p2dr_recovers_rigid_rotation():
    tp = _port_params(_jax_params(head_scale=1.0))
    p0 = tp.nodes[:, :3].detach()
    R = torch.tensor(_rotmat([0.3, 1.0, -0.2], 0.7), dtype=torch.float32)
    p = p0 @ R.T + torch.tensor([0.1, -0.2, 0.05])
    q = tnodes.p2dR(tp, CFG, p=p, p0=p0, K=8, mode="nodes")
    err = float((quat_to_rotmat(q) - R[None]).abs().max())
    assert err < 5e-3, err


def test_warp_with_bias_translation():
    tp = _port_params(_jax_params(head_scale=1.0))
    rs = np.random.RandomState(2)
    x = T((rs.normal(size=(40, 3)) * 0.5).astype(np.float32))
    feat = torch.zeros((40, CFG.hyper_dim))
    mm = torch.ones((40, 1))
    c = torch.tensor([0.25, -0.1, 0.4])
    base = tnodes.warp(tp, CFG, x, 0.3, feature=feat, motion_mask=mm)
    out = tnodes.warp_with_bias(tp, CFG, x, 0.3, feat, mm,
                                node_trans_bias=c.expand(CFG.node_num, 3))
    np.testing.assert_allclose(out["d_xyz"].numpy(),
                               (base["d_xyz"] + c).detach().numpy(),
                               rtol=1e-3, atol=1e-3)
    qb = out["d_rotation_bias"].numpy()
    np.testing.assert_allclose(np.abs(qb[:, 0]), 1.0, atol=1e-3)
    np.testing.assert_allclose(qb[:, 1:], 0.0, atol=1e-3)


# ------------------------------------------------------ cli edit

EDIT_TINY = ["--sh_degree", "1", "--hyper_dim", "2", "--node_num", "16",
             "--gaussian_capacity", "256", "--node_gauss_capacity", "64",
             "--raster_tile_cap", "256", "--raster_chunk", "64"]


def _edit_model(tmp_path, deform_type="node"):
    """A tiny D-NeRF scene and a JAX checkpoint of it: the JAX
    init_train_state made opaque, the warp head raised so the nodes move
    with t; cfg_args.json from the JAX parser."""
    from test_torch_data_io import dnerf_fixture

    from d2dgs_tpu import cli as jcli
    from d2dgs_tpu.io.checkpoint import save_train_state
    from d2dgs_tpu.train.trainer import init_train_state
    root = dnerf_fixture(tmp_path / "scene", n_cams=3, n_times=2, H=24,
                         W=24, n_test=2)
    model = str(tmp_path / "model")
    args = jcli._base_parser("train", True).parse_args(
        ["-s", root, "-m", model, "--no-raster_use_pallas",
         "--deform_type", deform_type, *EDIT_TINY])
    jcli.save_cfg_args(model, args)
    cfg = jcli.config_from_args(args)
    info = jcli._load_scene(args)
    st = init_train_state(jax.random.PRNGKey(0), cfg,
                          *jcli._init_points(info, cfg, 0))
    g = dataclasses.replace(st.gauss, opacity=jnp.full_like(
        st.gauss.opacity, 3.0))
    nodes = st.nodes
    if deform_type == "node":
        mlp = jax.tree.map(np.asarray, nodes.mlp)
        mlp["warp"]["w"] = mlp["warp"]["w"] * np.float32(1e3)
        nodes = dataclasses.replace(nodes, mlp=jax.tree.map(jnp.asarray,
                                                            mlp))
    save_train_state(os.path.join(model, "ckpt.npz"),
                     st._replace(gauss=g, nodes=nodes), 1, 1)
    return root, model, np.asarray(nodes.nodes[:, :3])


def test_cli_edit_matches_jax(tmp_path):
    """Both CLIs edit the same checkpoint: one handle at a node, a drag
    with an arc, 3 frames.  The frames agree to one 8-bit level (the two
    renders round float32 differently only at pixel-value boundaries),
    the GIFs exist, the port's handles land on their targets and its
    solved nodes are finite."""
    from PIL import Image

    from d2dgs_tpu import cli as jcli
    from d2dgs_torch import cli as tcli
    root, model, nodes = _edit_model(tmp_path)
    h = ",".join(f"{v:.6f}" for v in nodes[3])
    argv = ["edit", "-s", root, "-m", model, "--ckpt", "ckpt.npz",
            "--time", "0.4", f"--handle={h}", "--drag=0.2,0.1,-0.1",
            "--arc=0.05,0.2,0.0", "--n_frames", "3", "--n_anchors", "4",
            "--arap_iters", "2"]
    assert jcli.main(argv + ["--out", "edit_jax"]) == 0
    report = {}
    assert tcli.main(argv + ["--out", "edit_port", "--device", "cpu"],
                     report=report) == 0
    for f in range(3):
        a = np.asarray(Image.open(os.path.join(
            model, "edit_port", f"frame_{f:04d}.png")), np.int32)
        b = np.asarray(Image.open(os.path.join(
            model, "edit_jax", f"frame_{f:04d}.png")), np.int32)
        assert a.shape == b.shape == (24, 24, 3)
        assert np.abs(a - b).max() <= 1, f
        assert (a > 0).any()
    for d in ("edit_port", "edit_jax"):
        assert os.path.exists(os.path.join(model, d, "edit.gif"))
    hidx = report["handle_idx"]
    for hp, solved in zip(report["handle_pos"], report["solved"]):
        assert np.isfinite(solved).all()
        np.testing.assert_allclose(solved[hidx], hp, atol=1e-5)
    assert len(report["solve_ms"]) == len(report["frame_ms"]) == 3


def test_cli_edit_refuses_non_node_models(tmp_path):
    from d2dgs_torch import cli as tcli
    root, model, _ = _edit_model(tmp_path, deform_type="static")
    with pytest.raises(SystemExit, match="deform_type node"):
        tcli.main(["edit", "-s", root, "-m", model, "--ckpt", "ckpt.npz",
                   "--handle", "0,0,0", "--drag", "0.1,0,0", "--device",
                   "cpu"])
