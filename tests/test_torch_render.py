"""Port parity, the whole served slice: a JAX TrainState is saved as a
checkpoint, loaded by d2dgs_torch, and one view is deformed (node warp)
and rendered by both packages; every RenderOutput field must agree, with
the JAX side on the work-queue Pallas forward kernel in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.io.checkpoint import save_train_state
from d2dgs_tpu.models import gaussians as jgauss
from d2dgs_tpu.models.deform import DeformConfig as JDeformConfig
from d2dgs_tpu.models.deform import deform_gaussians as jdeform
from d2dgs_tpu.render.renderer import render as jrender
from d2dgs_tpu.train.config import TrainConfig
from d2dgs_tpu.train.trainer import init_train_state
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.io.from_jax import from_jax_arrays, load_jax_checkpoint
from d2dgs_torch.models import gaussians as tgauss
from d2dgs_torch.models.deform import DeformConfig, apply_deform_field
from d2dgs_torch.models.deform_mlp import MLPConfig
from d2dgs_torch.models.nodes import NodeConfig
from d2dgs_torch.render.renderer import render

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

AUX = dict(rtol=1e-4, atol=1e-5)
CAM = dict(azimuth=0.3, elevation=0.2, radius=3.0, fov=0.8, H=32, W=32,
           time=0.4)
# a tiny TrainConfig (as __graft_entry__._tiny_cfg) with small Pallas
# caps, so interpret mode walks few grid steps
CFG = TrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                  gaussian_capacity=256, node_gauss_capacity=128, warm_up=0,
                  raster=JRasterConfig(tile_cap=256, chunk=64, pair_cap=1024,
                                       emission_cap=1 << 14,
                                       pallas_interpret=True))


def T(a):
    return torch.from_numpy(np.array(a))


def _jax_state():
    rs = np.random.RandomState(0)
    pts = (rs.normal(size=(128, 3)) * 0.5).astype(np.float32)
    cols = rs.uniform(size=(128, 3)).astype(np.float32)
    state = init_train_state(jax.random.PRNGKey(1), CFG, pts, cols)
    g = state.gauss
    cap = g.capacity
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    # a non-trivial scene: random opacities, anisotropic scales, rotations,
    # SH band 1 active
    g = dataclasses.replace(
        g, opacity=f32(rs.normal(size=(cap, 1)) + 1.0),
        scaling=f32(np.log(np.exp(rs.normal(size=(cap, 2)) * 0.3) * 0.08)),
        rotation=f32(rs.normal(size=(cap, 4)) + [1.0, 0, 0, 0]),
        features_rest=f32(rs.normal(size=g.features_rest.shape) * 0.1),
        active_sh_degree=jnp.int32(1))
    # deform heads scaled from their near-identity init so the warp moves
    # the Gaussians visibly
    mlp = jax.tree.map(np.asarray, state.nodes.mlp)
    for h, f in {"warp": 1e3, "rotation": 1e3, "scaling": 1e6,
                 "local_rotation": 1e2}.items():
        mlp[h]["w"] = mlp[h]["w"] * np.float32(f)
    nodes = dataclasses.replace(state.nodes, mlp=jax.tree.map(jnp.asarray,
                                                              mlp))
    return state._replace(gauss=g, nodes=nodes)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    state = _jax_state()
    path = str(tmp_path_factory.mktemp("ckpt") / "state.npz")
    save_train_state(path, state, iteration=7)
    return state, path


def _jax_view(state):
    cam = jorbit(**CAM)
    g, nodes = state.gauss, state.nodes
    d = jdeform(nodes, JDeformConfig(deform_type="node", node=CFG.node_cfg),
                g.xyz, cam.time, feature=g.feature, motion_mask=g.motion_mask)
    bg = jnp.array([0.1, 0.2, 0.3])
    return d, jrender(cam, g, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"],
                      d_scaling=d["d_scaling"], cfg=CFG.raster)


def _port_node_cfg():
    nc = CFG.node_cfg
    return NodeConfig(node_num=nc.node_num, K=nc.K, hyper_dim=nc.hyper_dim,
                      d_rot_as_res=nc.d_rot_as_res,
                      exact_knn=nc.exact_knn,
                      mlp=MLPConfig(**dataclasses.asdict(nc.mlp)))


def _port_view(gauss, nodes, screen_probe=None):
    cam = orbit_camera(**CAM, device="cpu")
    d = apply_deform_field(nodes, DeformConfig(node=_port_node_cfg()),
                           gauss.xyz, cam.time, feature=gauss.feature,
                           motion_mask=gauss.motion_mask)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        return d, render(cam, gauss, bg, d_xyz=d["d_xyz"],
                         d_rotation=d["d_rotation"],
                         d_scaling=d["d_scaling"], screen_probe=screen_probe)


def test_whole_slice_matches_jax(saved):
    state, path = saved
    gauss, nodes = load_jax_checkpoint(path, device="cpu")
    assert gauss.active_sh_degree == 1 and gauss.max_sh_degree == 1
    jd, jo = _jax_view(state)
    td, to = _port_view(gauss, nodes)
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        np.testing.assert_allclose(td[k].detach().numpy(), np.asarray(jd[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(jnp.abs(jo.alpha).max()) > 0.5, "the view must show splats"
    for f in jo._fields:
        a, b = getattr(to, f).detach().numpy(), np.asarray(getattr(jo, f))
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, **AUX, err_msg=f)
    assert int(to.overflow) == 0 and int(to.clamped) == 0
    # the zero-valued densify probe leaves the render unchanged
    _, tp = _port_view(gauss, nodes,
                       screen_probe=torch.zeros(gauss.capacity, 2))
    torch.testing.assert_close(tp.image, to.image, rtol=0, atol=0)


def test_from_jax_arrays_matches_checkpoint(saved):
    state, path = saved
    leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(state)[0]}
    g1, n1 = from_jax_arrays(leaves, device="cpu")
    g2, n2 = load_jax_checkpoint(path, device="cpu")
    for a, b in ((g1, g2), (n1, n2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    np.testing.assert_array_equal(g1.xyz.detach().numpy(),
                                  np.asarray(state.gauss.xyz))
    np.testing.assert_array_equal(
        n1.mlp["layers"][5]["w"].detach().numpy(),
        np.asarray(state.nodes.mlp["layers"][5]["w"]))
    np.testing.assert_array_equal(
        n1.mlp["timenet"]["w0"].detach().numpy(),
        np.asarray(state.nodes.mlp["timenet"]["w0"]))


def test_checkpoint_format_checked(tmp_path):
    old = tmp_path / "old.npz"
    np.savez(old, leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match="format 1"):
        load_jax_checkpoint(str(old), device="cpu")


def test_create_from_pcd_parity():
    rs = np.random.RandomState(5)
    pts = rs.normal(size=(90, 3)).astype(np.float32)
    cols = rs.uniform(size=(90, 3)).astype(np.float32)
    j = jgauss.create_from_pcd(pts, cols, 128, sh_degree=2, fea_dim=3)
    t = tgauss.create_from_pcd(pts, cols, 128, sh_degree=2, fea_dim=3,
                               device="cpu")
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "feature", "alive"):
        np.testing.assert_allclose(getattr(t, f).detach().numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert t.max_sh_degree == 2 and t.active_sh_degree == 0
    jm = jgauss.apply_deform(j)
    tm = tgauss.apply_deform(t)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
