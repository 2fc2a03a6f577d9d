"""Port parity, gradients of the served slice: the preprocess VJP, the dense
oracle's gradients, the control-node warp's gradients and the densify
probe's gradient of d2dgs_torch against d2dgs_tpu (autograd on both
sides, the same numpy inputs and cotangents).

Gradients are compared max-normalised per array at the tolerance the JAX
package holds its own kernel gradients to (tests/test_pallas_blend.py):
rtol 2e-4, atol 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data import cameras as jcams
from d2dgs_tpu.models import deform_mlp as jmlp
from d2dgs_tpu.models import nodes as jnodes
from d2dgs_tpu.ops.dense_raster import rasterize_dense as jdense
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.render.renderer import render as jrender
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_torch.data import cameras as tcams
from d2dgs_torch.io.from_jax import from_jax_arrays
from d2dgs_torch.models import deform_mlp as tmlp
from d2dgs_torch.models import nodes as tnodes
from d2dgs_torch.ops.dense_raster import rasterize_dense
from d2dgs_torch.ops.projection import preprocess
from d2dgs_torch.render.renderer import render

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

GRAD = dict(rtol=2e-4, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def close_normalised(port, ref, what=""):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0, f"{what}: the reference gradient is zero"
    scale = np.abs(ref).max()
    np.testing.assert_allclose(port / scale, ref / scale, **GRAD,
                               err_msg=what)


def _splats(n=160, seed=0, opaque=False):
    """The shapes of tests/test_pallas_blend.py: 160 splats."""
    rs = np.random.RandomState(seed)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + 1.0)))
    if opaque:
        opac = np.full(n, 0.999)
    colors = rs.uniform(size=(n, 3))
    return [np.asarray(a, np.float32)
            for a in (means, scales, quats, opac, colors)]


CAMS = [dict(azimuth=0.4, elevation=0.3, radius=3.0, fov=0.8, H=48, W=64,
             time=0.25),
        dict(azimuth=-1.2, elevation=-0.5, radius=5.0, fov=0.5, H=37, W=61,
             time=0.9, target=(0.1, -0.2, 0.3))]


@pytest.mark.parametrize("kw", CAMS, ids=["orbit", "offset"])
def test_preprocess_vjp_parity(kw):
    """Cotangents on every differentiable Preprocessed field (T, normal,
    depth, center) -> gradients in means, scales and quaternions."""
    means, scales, quats, *_ = _splats()
    n = means.shape[0]
    rs = np.random.RandomState(1)
    cot = {"T": rs.normal(size=(n, 3, 3)), "normal": rs.normal(size=(n, 3)),
           "depth": rs.normal(size=n), "center": rs.normal(size=(n, 2))}
    cot = {k: np.asarray(v, np.float32) for k, v in cot.items()}
    jcam = jcams.orbit_camera(**kw)
    tcam = tcams.orbit_camera(**kw, device="cpu")

    def jloss(m, s, q):
        p = jpreprocess(m, s, q, jcam, 1.3)
        return sum(jnp.sum(getattr(p, k) * v) for k, v in cot.items())

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (means, scales, quats)))
    tin = [T(a).requires_grad_() for a in (means, scales, quats)]
    p = preprocess(*tin, tcam, 1.3)
    tl = sum(torch.sum(getattr(p, k) * T(v)) for k, v in cot.items())
    tg = torch.autograd.grad(tl, tin)
    for name, a, b in zip(("means", "scales", "quats"), tg, jg):
        close_normalised(a, b, name)


@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_dense_oracle_gradient_parity(opaque):
    """rasterize_dense: cotangents on the image and on every allmap
    channel -> gradients in all five splat inputs."""
    arrs = _splats(opaque=opaque)
    kw = CAMS[0]
    jcam = jcams.orbit_camera(**kw)
    tcam = tcams.orbit_camera(**kw, device="cpu")
    rs = np.random.RandomState(2)
    gc = rs.normal(size=(48, 64, 3)).astype(np.float32)
    ga = rs.normal(size=(48, 64, 8)).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.4], np.float32)

    def jloss(*x):
        c, a, *_ = jdense(*x, jcam, jnp.asarray(bg))
        return jnp.sum(c * gc) + jnp.sum(a * ga)

    jg = jax.grad(jloss, argnums=range(5))(*map(jnp.asarray, arrs))
    tin = [T(a).requires_grad_() for a in arrs]
    c, a, *_ = rasterize_dense(*tin, tcam, T(bg))
    tg = torch.autograd.grad(torch.sum(c * T(gc)) + torch.sum(a * T(ga)),
                             tin)
    for name, x, y in zip(("means", "scales", "quats", "opacity", "colors"),
                          tg, jg):
        close_normalised(x, y, name)


def _node_setup(local_frame):
    """24 nodes (one dead) with a 4x32 MLP whose heads are scaled up from
    their near-identity init; exact float32 KNN selection on both sides,
    so near-tie neighbours cannot differ.  Node and Gaussian hyper coords
    are spread (not the init's uniform 1e-2), so the binding weights, and
    the gradients in the hyper coords, are far from symmetric: with equal
    hyper coords those gradients cancel to float32 rounding noise."""
    cfg = jnodes.NodeConfig(
        node_num=24, K=3, hyper_dim=2, exact_knn=True,
        mlp=jmlp.MLPConfig(depth=4, width=32, is_blender=True,
                           local_frame=local_frame))
    rs = np.random.RandomState(3)
    pcl = rs.normal(size=(200, 3)).astype(np.float32) * 0.6
    params = jnodes.init_node_params(jax.random.PRNGKey(4), cfg)
    params = jnodes.init_nodes_from_pcl(params, cfg, jnp.asarray(pcl),
                                        jax.random.PRNGKey(5))
    mlp = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(6),
                                                 cfg.mlp))
    for h, f in {"warp": 1e3, "scaling": 1e6, "rotation": 1e3,
                 "local_rotation": 1e2}.items():
        if h in mlp:
            mlp[h]["w"] = mlp[h]["w"] * np.float32(f)
    alive = np.ones(24, bool)
    alive[7] = False
    hyper = np.asarray(rs.normal(size=(24, 2)) * 0.3, np.float32)
    params = dataclasses.replace(
        params, mlp=jax.tree.map(jnp.asarray, mlp),
        nodes=params.nodes.at[:, 3:].set(hyper),
        node_weight=jnp.asarray(rs.normal(size=(24, 1)), jnp.float32),
        alive=jnp.asarray(alive))
    port = tnodes.NodeParams(
        T(params.nodes), T(params.node_radius), T(params.node_weight),
        tmlp.mlp_from_arrays(params.mlp, "cpu"), T(params.alive))
    pcfg = tnodes.NodeConfig(
        node_num=24, K=3, hyper_dim=2, exact_knn=True,
        mlp=tmlp.MLPConfig(**dataclasses.asdict(cfg.mlp)))
    x = rs.normal(size=(150, 3)).astype(np.float32) * 0.6
    feat = (rs.normal(size=(150, 2)) * 0.3).astype(np.float32)
    mm = (1.0 / (1.0 + np.exp(-rs.normal(size=(150, 1))))).astype(np.float32)
    return cfg, params, pcfg, port, x, feat, mm


@pytest.mark.parametrize("local_frame", [True, False],
                         ids=["local_frame", "plain_lbs"])
def test_warp_gradient_parity(local_frame):
    """The node warp with cotangents on d_xyz, d_rotation and d_scaling
    -> gradients in the MLP, the node hyper coords, radii and weights,
    the Gaussians' hyper coords and their motion mask."""
    cfg, jp, pcfg, tp, x, feat, mm = _node_setup(local_frame)
    rs = np.random.RandomState(8)
    cot = {"d_xyz": rs.normal(size=(150, 3)),
           "d_rotation": rs.normal(size=(150, 4)),
           "d_scaling": rs.normal(size=(150, 2))}
    cot = {k: np.asarray(v, np.float32) for k, v in cot.items()}

    def jloss(mlp, nodes, radius, weight, f, m):
        p = dataclasses.replace(jp, mlp=mlp, nodes=nodes, node_radius=radius,
                                node_weight=weight)
        o = jnodes.warp(p, cfg, jnp.asarray(x), 0.3, f, m)
        return sum(jnp.sum(o[k] * v) for k, v in cot.items())

    jg = jax.grad(jloss, argnums=range(6))(
        jp.mlp, jp.nodes, jp.node_radius, jp.node_weight, jnp.asarray(feat),
        jnp.asarray(mm))
    tf, tm = T(feat).requires_grad_(), T(mm).requires_grad_()
    o = tnodes.warp(tp, pcfg, T(x), 0.3, tf, tm)
    tl = sum(torch.sum(o[k] * T(v)) for k, v in cot.items())
    names = dict(tp.mlp.named_parameters())
    inputs = [*names.values(), tp.nodes, tp.node_radius, tp.node_weight, tf,
              tm]
    tg = torch.autograd.grad(tl, inputs, allow_unused=True)
    jmlp_g = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in p): v for p, v in
              jax.tree_util.tree_flatten_with_path(jg[0])[0]}
    ref = [jmlp_g[k] for k in names] + list(jg[1:])
    labels = list(names) + ["nodes", "node_radius", "node_weight",
                            "feature", "motion_mask"]
    for label, a, b in zip(labels, tg, ref):
        if float(np.abs(np.asarray(b)).max()) == 0.0:
            # heads the warp does not read (none here) and the xyz part
            # of the nodes, which the warp takes without gradient
            assert a is None or float(a.abs().max()) == 0.0, label
            continue
        close_normalised(a, b, label)


def test_probe_gradient_parity():
    """The zero-valued densify probe of render(): its gradient (the
    reference's screen-space densify statistic) through the whole tiled
    render, port (plain blend under autograd) against JAX (XLA blend)."""
    jcfg = JTrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                        gaussian_capacity=256, node_gauss_capacity=128)
    rs = np.random.RandomState(0)
    pts = (rs.normal(size=(128, 3)) * 0.5).astype(np.float32)
    cols = rs.uniform(size=(128, 3)).astype(np.float32)
    state = jtrainer.init_train_state(jax.random.PRNGKey(1), jcfg, pts, cols)
    cap = state.gauss.capacity
    g = dataclasses.replace(
        state.gauss,
        opacity=jnp.asarray(rs.normal(size=(cap, 1)) + 1.0, jnp.float32),
        rotation=jnp.asarray(rs.normal(size=(cap, 4)) + [1.0, 0, 0, 0],
                             jnp.float32))
    state = state._replace(gauss=g)
    leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(state)[0]}
    tg_params, _ = from_jax_arrays(leaves, device="cpu")
    kw = dict(azimuth=0.3, elevation=0.2, radius=3.0, fov=0.8, H=32, W=32)
    gt = rs.uniform(size=(32, 32, 3)).astype(np.float32)
    ga = rs.normal(size=(32, 32, 1)).astype(np.float32)

    def jloss(probe):
        out = jrender(jcams.orbit_camera(**kw), g, jnp.zeros(3),
                      screen_probe=probe,
                      cfg=JRasterConfig(use_pallas=False, tile_cap=256))
        return jnp.sum((out.image - gt) ** 2) + jnp.sum(out.depth * ga)

    jg = jax.grad(jloss)(jnp.zeros((cap, 2)))
    probe = torch.zeros((cap, 2), requires_grad=True)
    out = render(tcams.orbit_camera(**kw, device="cpu"), tg_params,
                 torch.zeros(3), screen_probe=probe)
    tl = torch.sum((out.image - T(gt)) ** 2) + torch.sum(out.depth * T(ga))
    tg, = torch.autograd.grad(tl, probe)
    assert int((np.abs(np.asarray(jg)).sum(-1) > 0).sum()) > 10
    close_normalised(tg, jg, "screen probe")
