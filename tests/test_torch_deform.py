"""Port parity, deformation: positional encodings, the deform MLP with its
timenet, the control-node KNN binding, FPS node init and the node warp of
d2dgs_torch against d2dgs_tpu, with the JAX weights carried across."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.models import deform_mlp as jmlp
from d2dgs_tpu.models import nodes as jnodes
from d2dgs_torch.models import deform_mlp as tmlp
from d2dgs_torch.models import nodes as tnodes
from d2dgs_torch.models.deform import DeformConfig, deform_gaussians

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)
# head init std -> ~1e-2 (JAX init: 1e-5, scaling 1e-8, local_rotation 1e-4)
HEAD_SCALE = {"warp": 1e3, "scaling": 1e6, "rotation": 1e3,
              "local_rotation": 1e2, "opacity": 1e3, "color": 1e3}


def T(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=TOL, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **tol, **kw)


def jax_mlp(cfg, seed):
    """JAX init, with the near-zero heads scaled up so the deltas are
    large enough to compare; both packages get these same arrays."""
    p = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(seed), cfg))
    for h, f in HEAD_SCALE.items():
        if h in p:
            p[h]["w"] = p[h]["w"] * np.float32(f)
    return p


def test_positional_encodings_parity():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(20, 3)).astype(np.float32)
    t = rs.uniform(size=(20, 1)).astype(np.float32)
    close(tmlp.positional_encoding(T(x), 10),
          jmlp.positional_encoding(jnp.asarray(x), 10))
    close(tmlp.positional_encoding(T(t), 6),
          jmlp.positional_encoding(jnp.asarray(t), 6))
    close(tmlp.progressive_band_encoding(T(t), 6, 1234, 5000),
          jmlp.progressive_band_encoding(jnp.asarray(t), 6, 1234, 5000))


MLP_CFGS = {
    "blender_local_frame": jmlp.MLPConfig(depth=4, width=32, is_blender=True,
                                          local_frame=True),
    "heads_progressive": jmlp.MLPConfig(depth=3, width=32, pred_opacity=True,
                                        pred_color=True, max_d_scale=1.5,
                                        progressive_band_time=True),
}


def port_mlp_cfg(cfg):
    return tmlp.MLPConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(MLP_CFGS))
def test_mlp_forward_parity(name):
    cfg = MLP_CFGS[name]
    p = jax_mlp(cfg, 1)
    rs = np.random.RandomState(2)
    x = rs.normal(size=(30, 3)).astype(np.float32)
    t = rs.uniform(size=(30, 1)).astype(np.float32)
    jo = jmlp.mlp_forward(p, cfg, jnp.asarray(x), jnp.asarray(t), step=2500)
    to = tmlp.mlp_forward(tmlp.mlp_from_arrays(p, "cpu"), port_mlp_cfg(cfg),
                          T(x), T(t), step=2500)
    assert set(to) == set(jo)
    for k, v in jo.items():
        if v is None:
            assert to[k] is None, k
        else:
            close(to[k], v, err_msg=k)
    # the port's own init draws the same tree of shapes
    mine = tmlp.init_mlp(port_mlp_cfg(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = lambda tree: jax.tree.map(np.shape, tree)
    assert shapes(jax.tree.map(lambda a: a.detach().numpy(),
                               {k: (list(map(dict, v)) if k == "layers"
                                    else dict(v)) for k, v in mine.items()})
                  ) == shapes(p)


def _node_setup(local_frame, d_rot_as_res=True):
    cfg = jnodes.NodeConfig(
        node_num=24, K=3, hyper_dim=2, d_rot_as_res=d_rot_as_res,
        exact_knn=True, mlp=jmlp.MLPConfig(depth=4, width=32, is_blender=True,
                                           local_frame=local_frame))
    rs = np.random.RandomState(3)
    pcl = rs.normal(size=(200, 3)).astype(np.float32) * 0.6
    params = jnodes.init_node_params(jax.random.PRNGKey(4), cfg)
    params = jnodes.init_nodes_from_pcl(params, cfg, jnp.asarray(pcl),
                                        jax.random.PRNGKey(5))
    alive = np.ones(24, bool)
    alive[7] = False                  # a dead capacity slot
    params = dataclasses.replace(
        params, mlp=jax_mlp(cfg.mlp, 6),
        node_weight=jnp.asarray(rs.normal(size=(24, 1)), jnp.float32),
        alive=jnp.asarray(alive))
    port = tnodes.NodeParams(
        T(params.nodes), T(params.node_radius), T(params.node_weight),
        tmlp.mlp_from_arrays(params.mlp, "cpu"), T(params.alive))
    pcfg = tnodes.NodeConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(tnodes.NodeConfig) if f.name != "mlp"},
        mlp=port_mlp_cfg(cfg.mlp))
    x = rs.normal(size=(150, 3)).astype(np.float32) * 0.6
    feat = (rs.normal(size=(150, 3)) * 0.05).astype(np.float32)
    mm = (1.0 / (1.0 + np.exp(-rs.normal(size=(150, 1))))).astype(np.float32)
    return cfg, params, pcfg, port, x, feat, mm


@pytest.mark.parametrize("local_frame,d_rot_as_res",
                         [(True, True), (False, True), (True, False)])
def test_warp_parity(local_frame, d_rot_as_res):
    cfg, jp, pcfg, tp, x, feat, mm = _node_setup(local_frame, d_rot_as_res)
    jw, jd, ji = jnodes.cal_nn_weight(jp, cfg, jnp.asarray(x),
                                      jnp.asarray(feat))
    tw, td, ti = tnodes.cal_nn_weight(tp, pcfg, T(x), T(feat))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert not (ti == 7).any(), "dead node selected"
    close(tw, jw)
    close(td, jd, tol=dict(rtol=1e-5, atol=1e-6))
    jo = jnodes.warp(jp, cfg, jnp.asarray(x), 0.3, jnp.asarray(feat),
                     jnp.asarray(mm))
    to = tnodes.warp(tp, pcfg, T(x), 0.3, T(feat), T(mm))
    # the local-frame translate R x + v - x cancels terms of |x| ~ 1, so
    # d_xyz carries float32 rounding of ~1e-7 absolute
    atol = {"d_xyz": 1e-6, "d_rotation": 1e-7, "d_scaling": 1e-7}
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        assert float(np.abs(np.asarray(jo[k])).max()) > 1e-3, k
        close(to[k], jo[k], tol=dict(rtol=1e-5, atol=atol[k]), err_msg=k)
    # the facade's node type is this warp
    fo = deform_gaussians(tp, DeformConfig(node=pcfg), T(x), 0.3,
                          feature=T(feat), motion_mask=T(mm))
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        torch.testing.assert_close(fo[k], to[k], rtol=0, atol=0)


def test_init_nodes_from_pcl_parity():
    cfg = jnodes.NodeConfig(node_num=16, hyper_dim=2)
    pcl = np.random.RandomState(8).normal(size=(120, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jp = jnodes.init_nodes_from_pcl(
        jnodes.init_node_params(jax.random.PRNGKey(0), cfg), cfg,
        jnp.asarray(pcl), key)
    pcfg = tnodes.NodeConfig(node_num=16, hyper_dim=2,
                             mlp=tmlp.MLPConfig())
    tp = tnodes.init_node_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    # FPS start: the JAX draw, passed in
    start = int(jax.random.randint(key, (), 0, pcl.shape[0]))
    tnodes.init_nodes_from_pcl(tp, pcfg, T(pcl), start=start)
    close(tp.nodes, jp.nodes, tol=dict(rtol=1e-6, atol=1e-7))
    close(tp.node_radius, jp.node_radius, tol=dict(rtol=1e-6, atol=1e-7))
    np.testing.assert_array_equal(tp.node_weight.detach().numpy(),
                                  np.asarray(jp.node_weight))
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    # fewer points than nodes: the cloud itself, the rest dead
    small = tnodes.init_nodes_from_pcl(tp, pcfg, T(pcl[:5]), start=0)
    assert int(small.num_alive) == 5


def test_deform_types_not_ported_raise():
    _, _, pcfg, tp, x, feat, mm = _node_setup(True)
    out = deform_gaussians(tp, DeformConfig(deform_type="static"), T(x), 0.5)
    assert all(float(out[k].abs().max()) == 0.0
               for k in ("d_xyz", "d_rotation", "d_scaling"))
    for kind in ("mlp", "hash"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            deform_gaussians(tp, DeformConfig(deform_type=kind), T(x), 0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnodes.warp(tp, dataclasses.replace(pcfg, skinning="dqb"), T(x), 0.5,
                    T(feat), T(mm))
