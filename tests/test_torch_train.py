"""Port parity, the training slice: the losses, the learning-rate schedule,
Adam, the densify statistics, the ARAP term, the blend's VJP and one whole
main-stage step of d2dgs_torch against d2dgs_tpu.  The JAX side runs its
work-queue Pallas kernels (K1 forward, K2 backward) in interpret mode;
the port runs its plain PyTorch versions on the CPU.  A JAX TrainState
reaches the port through d2dgs_torch.io.from_jax.

Gradient tolerances are those of the JAX package's own kernel gradients
(tests/test_pallas_blend.py): max-normalised per array, rtol 2e-4,
atol 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.models import densify as jdensify
from d2dgs_tpu.models import regularizers as jreg
from d2dgs_tpu.ops import ssim as jssim
from d2dgs_tpu.ops.binning import bin_gaussians as jbin
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.ops.projection import tile_grid
from d2dgs_tpu.ops.tiled_raster import blend_tiles as jblend_tiles
from d2dgs_tpu.train import optim as joptim
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_tpu.utils import general as jgeneral
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.io.from_jax import train_state_from_jax_arrays
from d2dgs_torch.models import densify as tdensify
from d2dgs_torch.models import regularizers as treg
from d2dgs_torch.ops import ssim as tssim
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import (DEAD_ROWS, BlendTiles, blend_bwd,
                                        blend_tiles_plain_vjp)
from d2dgs_torch.ops.projection import Preprocessed
from d2dgs_torch.ops.tiled_raster import blend_tiles, pack_features
from d2dgs_torch.train import optim as toptim
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.train.config import TrainConfig
from d2dgs_torch.utils import general as tgeneral

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

GRAD = dict(rtol=2e-4, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def close_normalised(port, ref, tol=GRAD, what=""):
    """Max-normalised comparison of one gradient-like array."""
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(port / scale, ref / scale, **tol,
                               err_msg=what)


# ---------------------------------------------------------------- losses

def test_ssim_psnr_l1_parity():
    rs = np.random.RandomState(0)
    a = rs.uniform(size=(37, 45, 3)).astype(np.float32)
    b = np.clip(a + rs.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    for f in ("ssim", "psnr", "l1"):
        np.testing.assert_allclose(
            float(getattr(tssim, f)(T(a), T(b))),
            float(getattr(jssim, f)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, err_msg=f)
    # the gradient of D-SSIM, through the self-adjoint blur
    ta = T(a).requires_grad_()
    g_port, = torch.autograd.grad(tssim.ssim(ta, T(b)), ta)
    g_ref = jax.grad(jssim.ssim)(jnp.asarray(a), jnp.asarray(b))
    close_normalised(g_port, g_ref, what="d ssim")


def test_expon_lr_schedule_parity():
    for kw in (dict(lr_init=8e-4, lr_final=8e-6, lr_delay_mult=0.01,
                    max_steps=30_000),
               dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=500,
                    lr_delay_mult=0.01, max_steps=4_000)):
        j, t = jgeneral.get_expon_lr_func(**kw), \
            tgeneral.get_expon_lr_func(**kw)
        for step in (-1, 0, 1, 250, 499, 500, 2_999, 30_000, 50_000):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                       atol=0, err_msg=f"{kw} {step}")


# ---------------------------------------------------------- Adam, stats

def test_adam_two_steps_parity():
    """Random trees, two steps with different per-leaf LRs: params, mu,
    nu and the count (float32 arithmetic in the same order: 1e-6)."""
    rs = np.random.RandomState(1)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 4, 3)}
    params = {k: rs.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    lrs = {"a": 1e-3, "b": 0.05, "c": 4e-3}
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.adam_init(jp)
    tp = {k: T(v) for k, v in params.items()}
    ts = toptim.adam_init(tp)
    for step in range(2):
        grads = {k: rs.normal(size=s).astype(np.float32) * 10.0 ** -step
                 for k, s in shapes.items()}
        grads["b"][:3] = 0.0            # zero gradients: no move
        jp, js = joptim.adam_update(jax.tree.map(jnp.asarray, grads), js, jp,
                                    lrs)
        ts = toptim.adam_update({k: T(v) for k, v in grads.items()}, ts, tp,
                                lrs)
        for k in shapes:
            for a, b in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                         (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
        assert int(ts.count) == int(js.count) == step + 1
    # a missing gradient counts as zero
    before = tp["a"].clone()
    toptim.adam_update({"a": None}, toptim.adam_init({"a": tp["a"]}),
                       {"a": tp["a"]}, 1e-3)
    torch.testing.assert_close(tp["a"], before, rtol=0, atol=0)


def test_add_stats_parity():
    rs = np.random.RandomState(2)
    c = 64
    st = [rs.uniform(size=c).astype(np.float32) for _ in range(3)]
    g = rs.normal(size=(c, 2)).astype(np.float32)
    vis = rs.uniform(size=c) > 0.4
    radii = rs.randint(0, 9, size=c).astype(np.float32)
    j = jdensify.add_stats(jdensify.DensifyStats(*map(jnp.asarray, st)),
                           jnp.asarray(g), jnp.asarray(vis),
                           jnp.asarray(radii))
    t = tdensify.add_stats(tdensify.DensifyStats(*map(T, st)), T(g), T(vis),
                           T(radii))
    for f in tdensify.DensifyStats._fields:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   err_msg=f)
    z = tdensify.init_stats(c, "cpu")
    assert all(float(a.abs().sum()) == 0 for a in z) and z.denom.shape == (c,)


# ------------------------------------------------------------- the state

# a tiny TrainConfig (as __graft_entry__._tiny_cfg) with small Pallas
# caps, so interpret mode walks few grid steps
JCFG = JTrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                    gaussian_capacity=256, node_gauss_capacity=128,
                    warm_up=0,
                    raster=JRasterConfig(tile_cap=256, chunk=64,
                                         pair_cap=1024, emission_cap=1 << 14,
                                         pallas_interpret=True))
CFG = TrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                  gaussian_capacity=256, node_gauss_capacity=128, warm_up=0)
CAM = dict(azimuth=0.3, elevation=0.2, radius=3.0, fov=0.8, H=32, W=32,
           time=0.4)


def _jax_state():
    """A non-trivial scene: random opacities, anisotropic scales and
    rotations, SH band 1 active, deform heads scaled up from their
    near-identity init so the warp moves the Gaussians."""
    rs = np.random.RandomState(0)
    pts = (rs.normal(size=(128, 3)) * 0.5).astype(np.float32)
    cols = rs.uniform(size=(128, 3)).astype(np.float32)
    state = jtrainer.init_train_state(jax.random.PRNGKey(1), JCFG, pts, cols)
    g = state.gauss
    cap = g.capacity
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    g = dataclasses.replace(
        g, opacity=f32(rs.normal(size=(cap, 1)) + 1.0),
        scaling=f32(np.log(np.exp(rs.normal(size=(cap, 2)) * 0.3) * 0.08)),
        rotation=f32(rs.normal(size=(cap, 4)) + [1.0, 0, 0, 0]),
        features_rest=f32(rs.normal(size=g.features_rest.shape) * 0.1),
        active_sh_degree=jnp.int32(1))
    mlp = jax.tree.map(np.asarray, state.nodes.mlp)
    for h, f in {"warp": 1e3, "rotation": 1e3, "scaling": 1e6,
                 "local_rotation": 1e2}.items():
        mlp[h]["w"] = mlp[h]["w"] * np.float32(f)
    nodes = dataclasses.replace(state.nodes, mlp=jax.tree.map(jnp.asarray,
                                                              mlp))
    return state._replace(gauss=g, nodes=nodes)


def _leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.fixture(scope="module")
def jstate():
    return _jax_state()


def test_train_state_carried_across(jstate):
    st = train_state_from_jax_arrays(_leaves(jstate), device="cpu")
    for k in ttrainer.GAUSS_FIELDS:
        np.testing.assert_array_equal(
            st.gauss_opt.mu[k].numpy(), np.asarray(jstate.gauss_opt.mu[k]))
    jm = jax.tree_util.tree_flatten_with_path(jstate.mlp_opt.nu)[0]
    assert len(jm) == len(st.mlp_opt.nu) == len(ttrainer.mlp_trainable(
        st.nodes))
    assert set(st.mlp_opt.mu) == set(ttrainer.mlp_trainable(st.nodes))
    assert set(st.node_opt.mu) == set(ttrainer.NODE_FIELDS)
    assert int(st.gauss_opt.count) == int(jstate.gauss_opt.count)
    np.testing.assert_array_equal(st.gauss_stats.denom.numpy(),
                                  np.asarray(jstate.gauss_stats.denom))
    # the stage-1 node Gaussians: isotropic, as the JAX trainer builds them
    assert st.ngauss.isotropic_shared_scale and st.ngauss.capacity == 128
    np.testing.assert_allclose(st.ngauss.get_scaling.detach().numpy(),
                               np.asarray(jstate.ngauss.get_scaling),
                               rtol=1e-6)
    assert st.ngauss_opt.count.dtype == torch.int32


def test_init_train_state_matches_jax_layout():
    rs = np.random.RandomState(3)
    pts = (rs.normal(size=(64, 3)) * 0.5).astype(np.float32)
    cols = rs.uniform(size=(64, 3)).astype(np.float32)
    j = jtrainer.init_train_state(jax.random.PRNGKey(0), JCFG, pts, cols)
    t = ttrainer.init_train_state(CFG, pts, cols,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    for k in ttrainer.GAUSS_FIELDS:
        np.testing.assert_allclose(getattr(t.gauss, k).detach().numpy(),
                                   np.asarray(getattr(j.gauss, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert float(t.gauss_opt.mu[k].abs().sum()) == 0.0
    assert set(t.mlp_opt.nu) == set(ttrainer.mlp_trainable(t.nodes))
    jm = jax.tree_util.tree_leaves(j.mlp_opt.mu)
    assert sorted(a.shape for a in jm) == sorted(
        tuple(a.shape) for a in t.mlp_opt.mu.values())
    assert t.nodes.nodes.shape == j.nodes.nodes.shape
    assert t.ngauss.capacity == j.ngauss.capacity
    assert t.gauss_stats.denom.shape == (CFG.gaussian_capacity,)


def test_train_config_defaults_match_jax():
    j, t = JTrainConfig(), TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        if f.name != "raster":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.deform_lr_init == j.deform_lr_init
    assert t.deform_lr_final == j.deform_lr_final
    jn, tn = j.node_cfg, t.node_cfg
    for f in ("node_num", "K", "hyper_dim", "d_rot_as_res", "exact_knn"):
        assert getattr(tn, f) == getattr(jn, f), f
    for f in dataclasses.fields(tn.mlp):
        assert getattr(tn.mlp, f.name) == getattr(jn.mlp, f.name), f.name
    assert t.deform_cfg.mlp.local_frame is False
    assert ttrainer.gauss_lr_tree(t, 1e-4) == jtrainer.gauss_lr_tree(j, 1e-4)


# ------------------------------------------------------------------ ARAP

def _arap_draws(key, m, sample_num=512):
    """JAX arap_loss's own draws from ``key``, to hand to the port."""
    k1, k2, k3 = jax.random.split(key, 3)
    return treg.ArapDraws(
        T(jax.random.uniform(k1)), T(jax.random.uniform(k2, (2,))),
        T(jax.random.gumbel(k3, (m,))) if m > sample_num else None)


@pytest.mark.parametrize("sample_num", [512, 8], ids=["all", "sampled"])
def test_arap_loss_and_gradient_parity(jstate, sample_num):
    """The ARAP energy and its gradient in the deform MLP, with JAX's
    draws passed in.  R is taken without gradient and R = V U^T does not
    see the SVD's paired sign choices, so the sign ambiguity cannot
    matter.  The stretch E1 - R E0 cancels edge terms ~1e2 times its size,
    so float32 rounds the energy at ~1e-5 relative (on this state the
    float64 energy is 3.48030e-4; the port's float32 value is 6e-6 from
    it, JAX's 3.5e-5): energy held to rtol 2e-4, the gradient to atol
    5e-4 of the largest entry of the whole MLP gradient (the d_xyz bias
    cancels from every edge, so its own gradient is rounding noise)."""
    st = train_state_from_jax_arrays(_leaves(jstate), device="cpu")
    key = jax.random.PRNGKey(7)
    jcfg = JCFG.node_cfg

    def jloss(mlp):
        nodes = dataclasses.replace(jstate.nodes, mlp=mlp)
        return jreg.arap_loss(nodes, jcfg, key, sample_num=sample_num)

    jl, jg = jax.value_and_grad(jloss)(jstate.nodes.mlp)
    tl = treg.arap_loss(st.nodes, CFG.node_cfg,
                        _arap_draws(key, 16, sample_num),
                        sample_num=sample_num)
    assert float(jl) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-4)
    names = ttrainer.mlp_trainable(st.nodes)
    tg = torch.autograd.grad(tl, list(names.values()), allow_unused=True)
    jflat = _flat(jg)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jflat.values())
    for (name, p), g in zip(names.items(), tg):
        g = torch.zeros_like(p) if g is None else g    # heads d_xyz skips
        np.testing.assert_allclose(g.numpy() / scale,
                                   np.asarray(jflat[name]) / scale,
                                   rtol=2e-4, atol=5e-4, err_msg=name)
    # the connectivity graph itself
    pts = np.random.RandomState(4).normal(size=(40, 3)).astype(np.float32)
    ji, jw, jk = jreg.connectivity_from_points(jnp.asarray(pts), K=10)
    ti, tw, tk = treg.connectivity_from_points(T(pts), K=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------- the blend's VJP

def _pallas_scene(opaque=False):
    """The shapes of tests/test_pallas_blend.py: 48x64, 160 splats."""
    n = 160
    rs = np.random.RandomState(0)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + 1.0)))
    if opaque:
        opac = np.full(n, 0.999)    # saturates T: early termination
    colors = rs.uniform(size=(n, 3))
    return [np.asarray(a, np.float32)
            for a in (means, scales, quats, opac, colors)]


@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_blend_tiles_vjp_matches_jax_k2(opaque):
    """The port's blend_tiles VJP (autograd through the plain blend on the
    CPU) against JAX blend_tiles on the work-queue kernels, K2 included,
    in interpret mode: the same preprocessed splats and cotangents on
    every map channel; gradients in Tmat, center, normal, colour and
    opacity."""
    means, scales, quats, opac, colors = _pallas_scene(opaque)
    cam = jorbit(0.4, 0.3, 3.0, fov=0.8, H=48, W=64)
    gx, gy = tile_grid(48, 64)
    jcfg = JRasterConfig(tile_cap=256, chunk=64, pair_cap=2048,
                         emission_cap=1 << 14, use_pallas=True,
                         pallas_interpret=True, use_workqueue=True)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), cam)
    op = jnp.where(prep.valid, jnp.asarray(opac), 0.0)
    jb = jbin(prep, gx, gy, jcfg, opacity=op)
    rs = np.random.RandomState(5)
    ntile = gx * gy
    gc = rs.normal(size=(ntile, 256, 3)).astype(np.float32)
    ga = rs.normal(size=(ntile, 256, 8)).astype(np.float32)
    inputs = (prep.T, prep.center, prep.normal, jnp.asarray(colors), op)

    def jloss(*x):
        c, a, _ = jblend_tiles(*x, jb, gx, gy, jcfg)
        return jnp.sum(c * gc) + jnp.sum(a * ga)

    jg = jax.grad(jloss, argnums=range(5))(*inputs)
    tp = Preprocessed(*(T(a) for a in prep))
    tb = bin_gaussians(tp, gx, gy, RasterConfig(), opacity=T(op))
    tin = [T(a).requires_grad_() for a in inputs]
    c, a, _ = blend_tiles(*tin, tb, gx, gy, RasterConfig())
    tl = torch.sum(c * T(gc)) + torch.sum(a * T(ga))
    tg = torch.autograd.grad(tl, tin)
    for name, x, y in zip(("Tmat", "center", "normal", "colors", "opacity"),
                          tg, jg):
        assert float(np.abs(np.asarray(y)).max()) > 0, name
        close_normalised(x, y, what=name)


def test_blend_backward_wrappers_on_cpu():
    """On CPU tensors K2's wrapper is its plain version and launches
    nothing; BlendTiles there pairs the plain forward with it."""
    means, scales, quats, opac, colors = map(T, _pallas_scene())
    cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device="cpu")
    gx, gy = tile_grid(48, 64)
    from d2dgs_torch.ops.projection import preprocess
    prep = preprocess(means, scales, quats, cam)
    op = torch.where(prep.valid, opac, 0.0)
    b = bin_gaussians(prep, gx, gy, RasterConfig(), opacity=op)
    fs = pack_features(prep.T, prep.center, prep.normal, colors, op)[
        b.order.long()].detach().contiguous()
    args = (b.pair_rank, b.tile_start, b.tile_count, gx)
    f = fs.clone().requires_grad_()
    state = BlendTiles.apply(f, *args)
    g = torch.randn(state.shape, generator=torch.Generator().manual_seed(0))
    before = blend_bwd.launches
    d_fn, = torch.autograd.grad(state, f, g)
    d_wrap = blend_bwd(fs, *args, state, None, g)
    assert blend_bwd.launches == before
    torch.testing.assert_close(d_fn, d_wrap, rtol=0, atol=0)
    # the plain VJP ignores the dead rows' cotangents, and a tile subset
    # gives the gradient of those tiles alone
    g_live = g.clone()
    g_live[:, list(DEAD_ROWS)] = 0.0
    tiles = torch.tensor([1, 5, 6])
    keep = torch.zeros(state.shape[0], dtype=torch.bool)
    keep[tiles] = True
    d_sub = blend_tiles_plain_vjp(fs, *args, g, tiles=tiles)
    d_full = blend_tiles_plain_vjp(fs, *args, torch.where(
        keep[:, None, None], g_live, 0.0))
    torch.testing.assert_close(d_sub, d_full, rtol=1e-6, atol=1e-6)
    assert float(d_sub.abs().max()) > 0


# ------------------------------------------------------ main_stage_step

SCHED = dict(lambda_normal=0.05, lambda_dist=1000.0, lambda_arap=0.01,
             deform_lr=8e-4, xyz_lr=8e-4)
# A step's gradients, max-normalised per array.  The distortion term (the
# reference's lambda 1000) cancels terms ~1 to a small difference, so its
# gradient carries float32 noise of a few 1e-4 of the largest entry: on
# this scene the JAX package's own two blend paths (XLA and K2) differ by
# 3.1e-4 on the distortion gradient of the Gaussians' positions.  Held to
# 3x that.
STEP = dict(rtol=2e-4, atol=1e-3)


def _gt():
    rs = np.random.RandomState(9)
    return rs.uniform(size=(32, 32, 3)).astype(np.float32)


def _flat(tree) -> dict:
    """A JAX pytree's leaves by the port's dotted parameter names."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _compare_step(ts, tm, js, jm, what):
    """Metrics, the three Adam groups (params, mu, nu, count) and the
    densify statistics after one step in both packages."""
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=f"{what} {k}")
    for k in ("num_pairs", "overflow", "alive"):
        assert int(tm[k]) == int(jm[k]), (what, k)
    xyz_lr = SCHED["xyz_lr"]
    groups = [
        ("gauss", ttrainer.gauss_trainable(ts.gauss), ts.gauss_opt,
         jtrainer.gauss_trainable(js.gauss), js.gauss_opt,
         ttrainer.gauss_lr_tree(CFG, xyz_lr)),
        ("node", ttrainer.node_trainable(ts.nodes), ts.node_opt,
         jtrainer.node_trainable(js.nodes), js.node_opt,
         dict.fromkeys(ttrainer.NODE_FIELDS, CFG.deform_lr_init)),
        ("mlp", ttrainer.mlp_trainable(ts.nodes), ts.mlp_opt,
         _flat(js.nodes.mlp), js.mlp_opt._replace(mu=_flat(js.mlp_opt.mu),
                                                  nu=_flat(js.mlp_opt.nu)),
         dict.fromkeys(_flat(js.nodes.mlp), SCHED["deform_lr"])),
    ]
    for gname, tp, topt, jp, jopt, lr in groups:
        assert int(topt.count) == int(jopt.count), (what, gname)
        assert set(tp) == set(jp) == set(topt.mu)
        for k in tp:
            tag = f"{what} {gname}.{k}"
            mu = np.asarray(jopt.mu[k])
            close_normalised(topt.mu[k], mu, tol=STEP, what=tag + " mu")
            close_normalised(topt.nu[k], jopt.nu[k], tol=STEP,
                             what=tag + " nu")
            # where the gradient is strong its sign and size are sure, and
            # Adam's move (about lr) agrees to 2% of lr
            strong = np.abs(mu) > 0.1 * np.abs(mu).max()
            np.testing.assert_allclose(
                tp[k].detach().numpy()[strong], np.asarray(jp[k])[strong],
                rtol=0, atol=0.02 * lr[k] + 1e-6, err_msg=tag + " param")
    for f in tdensify.DensifyStats._fields:
        close_normalised(getattr(ts.gauss_stats, f),
                         getattr(js.gauss_stats, f), tol=STEP,
                         what=f"{what} stats.{f}")


@pytest.mark.parametrize("warm", [0.0, 1.0], ids=["warm0", "warm1"])
def test_main_stage_step_two_steps_match_jax(jstate, warm):
    """Two main-stage steps, each from the same carried-across TrainState
    in both packages (step 2 starts from the JAX state after step 1, so
    it also checks Adam with moments and a count).  Adam starts from zero
    moments, so after step 1 mu = 0.1 g and nu = 1e-3 g^2 hold every
    gradient (Gaussians, deform MLP, nodes, the screen probe through the
    densify statistics).  A fresh Adam step moves an element by about
    +-lr whatever its gradient's size, so parameters are compared only
    where the gradient is strong; elsewhere the moments decide."""
    gt = _gt()
    sched_j = {k: jnp.float32(v) for k, v in SCHED.items()}
    sched_j["warm"] = jnp.float32(warm)
    sched_t = dict(SCHED, warm=warm)
    jcam = jorbit(**CAM)
    tcam = orbit_camera(**CAM, device="cpu")
    js = jstate
    for step in range(2):
        ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
        draws = _arap_draws(jax.random.split(js.key)[1], 16)
        js, jm = jtrainer.main_stage_step(js, jcam, jnp.asarray(gt), JCFG,
                                          sched_j)
        ts, tm = ttrainer.main_stage_step(ts, tcam, T(gt), CFG, sched_t,
                                          arap_draws=draws)
        _compare_step(ts, tm, js, jm, f"warm {warm} step {step + 1}")
        assert float(ts.gauss_stats.denom.max()) == step + 1
        assert float(ts.gauss_stats.grad_accum.max()) > 0
    if warm == 1.0:
        # before the warm-up ends the deform MLP gets no gradient
        for v in ts.mlp_opt.mu.values():
            assert float(v.abs().max()) == 0.0


def test_main_stage_step_flow_term_changes_mlp_update(jstate):
    """The optical-flow term reaches the deform MLP: one step with a flow
    sample updates it otherwise than the same step without one (the JAX
    package's tests/test_flow_loss.py check, on the port)."""
    cam = orbit_camera(**CAM, device="cpu")
    cam2 = orbit_camera(**dict(CAM, time=0.7), device="cpu")
    rs = np.random.RandomState(11)
    flow = T((rs.normal(size=(32, 32, 2)) * 0.05).astype(np.float32))
    draws = _arap_draws(jax.random.split(jstate.key)[1], 16)
    mlps = []
    for flow_loss in (False, True):
        ts = train_state_from_jax_arrays(_leaves(jstate), device="cpu")
        ts, m = ttrainer.main_stage_step(
            ts, cam, T(_gt()), CFG, dict(SCHED, warm=0.0,
                                         lambda_optical=0.1),
            flow_sample=(cam2, flow, torch.ones(32, 32, 1), 1.0),
            flow_loss=flow_loss, arap_draws=draws)
        assert np.isfinite(float(m["loss"]))
        mlps.append({k: v.detach().clone() for k, v in
                     ttrainer.mlp_trainable(ts.nodes).items()})
    diff = sum(float((mlps[0][k] - mlps[1][k]).abs().sum())
               for k in mlps[0])
    assert diff > 0.0


def _gt_alpha(seed=4):
    a = np.random.RandomState(seed).uniform(size=(CAM["H"], CAM["W"], 1))
    return (a > 0.5).astype(np.float32)


@pytest.mark.parametrize("deformed", [False, True])
def test_motion_mask_loss_matches_jax(jstate, deformed):
    """The detached-geometry render with colours [mask, 0, 1 - mask]: the
    same L1 and the same gradient, which reaches only the motion-mask
    logits (the last feature channel)."""
    from d2dgs_tpu.models.deform import deform_gaussians as jdeform
    from d2dgs_torch.models.deform import apply_deform_field as tdeform
    alpha = _gt_alpha()
    jcam, tcam = jorbit(**CAM), orbit_camera(**CAM, device="cpu")
    js = jstate
    ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
    bg_j, bg_t = jnp.zeros(3), torch.zeros(3)

    def jloss(feature):
        g = dataclasses.replace(js.gauss, feature=feature)
        d = jdeform(js.nodes, JCFG.deform_cfg, g.xyz, jcam.time,
                    feature=g.feature, motion_mask=g.motion_mask) \
            if deformed else None
        return jtrainer.motion_mask_loss(g, jcam, jnp.asarray(alpha), bg_j,
                                         JCFG, d=d)

    j_val, j_grad = jax.value_and_grad(jloss)(js.gauss.feature)
    g = ts.gauss
    d = tdeform(ts.nodes, CFG.deform_cfg, g.xyz, tcam.time,
                feature=g.feature, motion_mask=g.motion_mask) \
        if deformed else None
    t_val = ttrainer.motion_mask_loss(g, tcam, T(alpha), bg_t, CFG, d=d)
    grads = torch.autograd.grad(
        t_val, [g.feature, g.xyz, g.opacity, ts.nodes.nodes],
        allow_unused=True)
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    assert float(np.abs(np.asarray(j_grad)[:, -1]).max()) > 0
    close_normalised(grads[0], j_grad, what="d feature")
    assert float(grads[0][:, :-1].abs().max()) == 0.0
    assert all(x is None or float(x.abs().max()) == 0.0 for x in grads[1:])


def test_main_stage_step_motion_term_matches_jax(jstate):
    """One main-stage step with the motion-mask term at weight 0.5."""
    sched = dict(SCHED, warm=0.0, lambda_motion=0.5)
    js = jstate
    ts = train_state_from_jax_arrays(_leaves(js), device="cpu")
    draws = _arap_draws(jax.random.split(js.key)[1], 16)
    alpha = _gt_alpha()
    js, jm = jtrainer.main_stage_step(
        js, jorbit(**CAM), jnp.asarray(_gt()), JCFG,
        {k: jnp.float32(v) for k, v in sched.items()},
        gt_alpha=jnp.asarray(alpha), motion_loss=True)
    ts, tm = ttrainer.main_stage_step(
        ts, orbit_camera(**CAM, device="cpu"), T(_gt()), CFG, sched,
        gt_alpha=T(alpha), motion_loss=True, arap_draws=draws)
    _compare_step(ts, tm, js, jm, "motion term")
    # the term moved the motion-mask logits
    assert float(ts.gauss_opt.mu["feature"][:, -1].abs().max()) > 0
