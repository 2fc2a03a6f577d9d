"""Port parity, the hash-grid deformation field: the corner indices
(bitwise), the encoding with its progressive band mask, the field's
forward and gradients, init names, the facade, and JAX<->port
checkpoints of a hash TrainState, d2dgs_torch against d2dgs_tpu with the
JAX weights carried across; then the cases of tests/test_hash_deform.py
run against the port.

Tolerances: outputs rtol 1e-5 / atol 1e-7 on O(1) values (the same
float32 operations in the same order, up to the matmul's summation);
gradients max-normalised per array at the JAX package's own kernel
gradient tolerance (tests/test_pallas_blend.py, rtol 2e-4, atol 2e-5),
since the tables' gradient is a scatter-add whose sum order is not
fixed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.models import deform as jdeform
from d2dgs_tpu.models import hash_deform as jhash
from d2dgs_torch.models import deform as tdeform
from d2dgs_torch.models import hash_deform as thash
from d2dgs_torch.models.deform_mlp import mlp_from_arrays
from d2dgs_torch.train import optim as toptim
from test_torch_train import _flat, close_normalised

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)

TINY = dict(n_levels=4, log2_hashmap_size=10, base_resolution=4,
            start_level=2, start_step=0, update_steps=10, num_layers=1,
            hidden=32, head_width=16)


def T(a):
    return torch.from_numpy(np.array(a))


def port_cfg(jcfg):
    return thash.HashConfig(**dataclasses.asdict(jcfg))


def jax_params(jcfg, seed=0, table_scale=1e4):
    """JAX init as numpy, the tables scaled to O(1) values and the main
    MLP's near-zero output layer raised, so every output is large enough
    to compare; both packages get these arrays."""
    p = jax.tree.map(np.asarray, jhash.init_hash_deform(
        jax.random.PRNGKey(seed), jcfg))
    p["tables"] = [t * np.float32(table_scale) for t in p["tables"]]
    if not jcfg.hash_time:
        p["mlp"][-1]["w"] = p["mlp"][-1]["w"] * np.float32(1e4)
    return p


# ------------------------------------------------------ corner indices

@pytest.mark.parametrize("hash_time", [False, True], ids=["3d", "4d"])
def test_corner_index_bitwise(hash_time):
    """Every level of the default config: in 3-D levels 0-2 are dense, in
    4-D only level 0; the rest hash with 32-bit wraparound.  Coordinates
    span [0, res], the corner range of hash_encode."""
    cfg = jhash.HashConfig(hash_time=hash_time)
    d = cfg.in_dim
    rs = np.random.RandomState(0)
    dense = []
    for lvl in range(cfg.n_levels):
        res = cfg.resolution(lvl)
        coords = rs.randint(0, res + 1, size=(4096, d)).astype(np.int32)
        coords[:2] = [[0] * d, [res] * d]            # the extreme corners
        want = np.asarray(jhash._corner_index(jnp.asarray(coords), res,
                                              cfg.table_size, d))
        got = thash._corner_index(T(coords), res, cfg.table_size, d)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"level {lvl}")
        assert int(got.max()) < cfg.table_size
        dense.append((res + 1) ** d <= cfg.table_size)
    assert dense == [lvl < (1 if hash_time else 3)
                     for lvl in range(cfg.n_levels)]


# -------------------------------------------------------------- encoding

STEPS = [0, 1_000, 3_500, 6_000, 10**9]


@pytest.mark.parametrize("step", STEPS)
def test_band_mask_and_encode_parity(step):
    """The default config (12 levels, 2^19 entries): the mask at each step
    and the encoding of random points plus the faces of the box (x01 of
    exactly 0 and 1, the boundary corner of the clip)."""
    cfg = jhash.HashConfig()
    tables = [np.asarray(jax.random.uniform(
        jax.random.PRNGKey(lvl), (cfg.table_size, cfg.n_features),
        minval=-1.0, maxval=1.0)) for lvl in range(cfg.n_levels)]
    rs = np.random.RandomState(1)
    x = rs.uniform(size=(500, 3)).astype(np.float32)
    x[:6] = [[1, 1, 1], [0, 0, 0], [1, 0, 0.5], [0.5, 1, 0], [1, 1, 0],
             [0.999999, 1, 0.25]]
    want = jhash.hash_encode([jnp.asarray(t) for t in tables], cfg,
                             jnp.asarray(x), step)
    got = thash.hash_encode([T(t) for t in tables], port_cfg(cfg), T(x),
                            step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    j = np.arange(cfg.enc_dim, dtype=np.float32)
    start, band = cfg.start_level * cfg.n_features, cfg.enc_dim - 12
    ramp = np.clip(np.float32(step) / cfg.n_masking_step * band
                   - (j - start), 0, 1)
    mask = np.where(j < start, 1.0, (1 - np.cos(np.pi * ramp)) / 2)
    np.testing.assert_allclose(
        thash.band_mask(port_cfg(cfg), step, "cpu").numpy(), mask,
        rtol=1e-6, atol=1e-7)
    if step <= 60:                      # chip_smoke.py phase 9's depth
        assert float(got[:, 13:].abs().max()) == 0.0


def test_x01_one_weighs_corner_res_minus_one():
    """At x01 == 1 the whole weight falls on corner res-1 (frac is taken
    before the clip), in both packages."""
    cfg = jhash.HashConfig(n_levels=2, log2_hashmap_size=12,
                           base_resolution=4, start_level=2)
    tables = [np.arange(cfg.table_size * 2, dtype=np.float32).reshape(
        -1, 2) + 1000.0 * lvl for lvl in range(2)]
    x = np.ones((1, 3), np.float32)
    got = thash.hash_encode([T(t) for t in tables], port_cfg(cfg), T(x),
                            10**9).numpy()
    want = np.asarray(jhash.hash_encode([jnp.asarray(t) for t in tables],
                                        cfg, jnp.asarray(x), 10**9))
    np.testing.assert_array_equal(got, want)
    for lvl in range(2):
        res = cfg.resolution(lvl)
        c = np.full((1, 3), res - 1)
        idx = int(thash._corner_index(T(c), res, cfg.table_size, 3)[0])
        np.testing.assert_array_equal(got[0, 2 * lvl:2 * lvl + 2],
                                      tables[lvl][idx])


# --------------------------------------------------------- the field

FIELD_CFGS = {
    "pe_time": jhash.HashConfig(**TINY),
    "hash_time": jhash.HashConfig(**TINY, hash_time=True),
    "heads": jhash.HashConfig(**TINY, local_frame=True, pred_opacity=True,
                              pred_color=True),
}


def test_init_names_and_shapes_spell_the_jax_tree():
    for jcfg in FIELD_CFGS.values():
        jp = _flat(jhash.init_hash_deform(jax.random.PRNGKey(0), jcfg))
        tp = dict(thash.init_hash_deform(
            port_cfg(jcfg), torch.Generator().manual_seed(0),
            device="cpu").named_parameters())
        assert set(tp) == set(jp)
        for k in tp:
            a, b = np.asarray(jp[k]), tp[k].detach().numpy()
            assert b.shape == a.shape, k
            # zero biases stay zero; the draws have the JAX init's spread
            if not a.any():
                assert not b.any(), k
            else:
                assert 0.5 < b.std() / a.std() < 2.0, k


@pytest.mark.parametrize("name", sorted(FIELD_CFGS))
@pytest.mark.parametrize("step", [3, 10**9])
def test_hash_deform_forward_and_grads_parity(name, step):
    jcfg = FIELD_CFGS[name]
    p = jax_params(jcfg)
    rs = np.random.RandomState(2)
    x = rs.uniform(-2.2, 2.2, size=(64, 3)).astype(np.float32)
    t = rs.uniform(size=(64, 1)).astype(np.float32)
    keys = [k for k in ("d_xyz", "d_rotation", "d_scaling", "d_opacity",
                        "d_color", "local_rotation")
            if k in ("d_xyz", "d_rotation", "d_scaling")
            or (k == "d_opacity" and jcfg.pred_opacity)
            or (k == "d_color" and jcfg.pred_color)
            or (k == "local_rotation" and jcfg.local_frame)]
    co = {k: rs.normal(size=(64, 4 if "rot" in k else
                              {"d_xyz": 3, "d_scaling": 2, "d_opacity": 1,
                               "d_color": 3}[k])).astype(np.float32)
          for k in keys}

    def jloss(params):
        o = jhash.hash_deform_forward(params, jcfg, jnp.asarray(x),
                                      jnp.asarray(t), step=step)
        return sum(jnp.sum(o[k] * co[k]) for k in keys), o

    (jl, jo), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    tp = mlp_from_arrays(p, "cpu")
    to = thash.hash_deform_forward(tp, port_cfg(jcfg), T(x), T(t),
                                   step=step)
    for k in keys:
        np.testing.assert_allclose(to[k].detach().numpy(),
                                   np.asarray(jo[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tl = sum(torch.sum(to[k] * T(co[k])) for k in keys)
    names, params = zip(*tp.named_parameters())
    grads = torch.autograd.grad(tl, params, allow_unused=True)
    jflat = _flat(jg)
    for k, g in zip(names, grads):
        ref = np.asarray(jflat[k])
        if g is None:
            assert np.abs(ref).max() == 0.0, k
            continue
        close_normalised(g, ref, what=k)


def test_facade_parity_mlp_hash_static():
    """apply_deform_field for the three fields without nodes, on carried
    weights (the node type's parity is tests/test_torch_deform.py and
    tests/test_torch_deform_types.py)."""
    from d2dgs_tpu.models.deform_mlp import MLPConfig as JMLPConfig
    from d2dgs_torch.models.deform_mlp import MLPConfig
    jmlp_cfg = JMLPConfig(is_blender=True, depth=3, width=32)
    rs = np.random.RandomState(3)
    x = rs.normal(size=(40, 3)).astype(np.float32)
    for dt in ("mlp", "hash", "static"):
        jcfg = jdeform.DeformConfig(deform_type=dt, mlp=jmlp_cfg,
                                    hash=jhash.HashConfig(**TINY))
        tcfg = tdeform.DeformConfig(
            deform_type=dt, mlp=MLPConfig(**dataclasses.asdict(jmlp_cfg)),
            hash=port_cfg(jcfg.hash))
        jp = jdeform.init_deform(jax.random.PRNGKey(4), jcfg)
        if dt == "hash":
            jp = jax_params(jcfg.hash, seed=4)
        elif dt == "mlp":
            jp = jax.tree.map(np.asarray, jp)
            jp["warp"]["w"] = jp["warp"]["w"] * np.float32(1e3)
        tp = mlp_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
        jo = jdeform.apply_deform_field(jax.tree.map(jnp.asarray, jp), jcfg,
                                        jnp.asarray(x), jnp.float32(0.3),
                                        step=2_000)
        to = tdeform.apply_deform_field(tp, tcfg, T(x), torch.tensor(0.3),
                                        step=2_000)
        for k in ("d_xyz", "d_rotation", "d_scaling"):
            np.testing.assert_allclose(to[k].detach().numpy(),
                                       np.asarray(jo[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{dt} {k}")
        assert to["d_opacity"] is None and to["d_color"] is None
        if dt == "static":
            assert float(to["d_xyz"].abs().max()) == 0.0


# ------------------------------------------------------- checkpoints

def _jax_hash_state():
    from d2dgs_tpu.config import RasterConfig as JRasterConfig
    from d2dgs_tpu.train import trainer as jtrainer
    from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
    jcfg = JTrainConfig(deform_type="hash", sh_degree=1, hyper_dim=2,
                        node_num=16, gaussian_capacity=64,
                        node_gauss_capacity=32,
                        raster=JRasterConfig(use_pallas=False))
    rs = np.random.RandomState(5)
    pts = rs.normal(size=(32, 3)).astype(np.float32)
    cols = rs.uniform(size=(32, 3)).astype(np.float32)
    st = jtrainer.init_train_state(jax.random.PRNGKey(6), jcfg, pts, cols)
    # non-zero moments and count, so the round trip carries them too
    mu = jax.tree.map(lambda a: a + 0.5, st.mlp_opt.mu)
    return jcfg, pts, cols, st._replace(
        mlp_opt=st.mlp_opt._replace(mu=mu, count=jnp.int32(7)))


def test_hash_checkpoint_roundtrips_with_jax(tmp_path):
    """A JAX hash TrainState saved by the JAX package loads into the
    port's template with every leaf bitwise, and the port's save loads
    back into the JAX package bitwise."""
    from d2dgs_tpu.io import checkpoint as jckpt
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.io import checkpoint as tckpt
    from d2dgs_torch.io.from_jax import load_jax_train_state
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import init_train_state
    jcfg, pts, cols, js = _jax_hash_state()
    path = str(tmp_path / "jax.npz")
    jckpt.save_train_state(path, js, 12, 3)
    cfg = TrainConfig(deform_type="hash", sh_degree=1, hyper_dim=2,
                      node_num=16, gaussian_capacity=64,
                      node_gauss_capacity=32, raster=RasterConfig())
    template = init_train_state(cfg, pts, cols, device="cpu")
    assert len(template.mlp_opt.mu) == len(jax.tree.leaves(js.mlp_opt.mu))
    st, it, it_node = tckpt.load_train_state(path, template)
    assert (it, it_node) == (12, 3)
    jleaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
               jax.tree_util.tree_flatten_with_path(js)[0]}
    tleaves = tckpt.tensor_leaves(st)
    assert any("['tables'][11]" in k for k in tleaves)
    for k, v in tleaves.items():
        np.testing.assert_array_equal(v.detach().numpy(), jleaves[k],
                                      err_msg=k)
    # from_jax builds the same state without a template
    st2 = load_jax_train_state(path, device="cpu")
    for k, v in tckpt.tensor_leaves(st2).items():
        np.testing.assert_array_equal(v.detach().numpy(), jleaves[k],
                                      err_msg=k)
    # the port's save back into the JAX package
    back = str(tmp_path / "port.npz")
    tckpt.save_train_state(back, st, 12, 3)
    from d2dgs_tpu.train import trainer as jtrainer
    jt = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, pts, cols)
    jr, it, it_node = jckpt.load_train_state(back, jt)
    assert (it, it_node) == (12, 3)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jr)[0],
                              jax.tree_util.tree_flatten_with_path(js)[0]):
        if jax.tree_util.keystr(p) == ".key":
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(p))


# ------------------------------- tests/test_hash_deform.py on the port

def _port_tiny():
    return thash.HashConfig(**TINY)


def test_encode_trilinear_within_cell():
    cfg = thash.HashConfig(n_levels=1, log2_hashmap_size=12,
                           base_resolution=4, start_level=1,
                           update_steps=1)
    params = thash.init_hash_deform(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    tables = [t.detach() * 1e4 for t in params["tables"]]
    a = torch.tensor([[0.05, 0.10, 0.20]])
    b = torch.tensor([[0.20, 0.10, 0.20]])            # same cell at res 4
    ea, eb, em = (thash.hash_encode(tables, cfg, p, step=10**9)
                  for p in (a, b, (a + b) / 2))
    np.testing.assert_allclose(em.numpy(), ((ea + eb) / 2).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_progressive_cosine_mask():
    cfg = _port_tiny()
    params = thash.init_hash_deform(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    tables = [t.detach() * 1e4 for t in params["tables"]]
    x = torch.rand((8, 3), generator=torch.Generator().manual_seed(1))
    e0 = thash.hash_encode(tables, cfg, x, step=0).numpy()
    efull = thash.hash_encode(tables, cfg, x, step=10**9).numpy()
    s = cfg.start_level * cfg.n_features
    assert np.abs(e0[:, s:]).max() == 0.0
    assert np.abs(e0[:, :s]).max() > 0.0
    assert np.abs(efull[:, s:]).max() > 0.0
    emid = thash.hash_encode(tables, cfg, x,
                             step=cfg.n_masking_step // 2).numpy()
    assert np.abs(emid[:, s:]).sum() <= np.abs(efull[:, s:]).sum() + 1e-6


def test_forward_shapes_and_identity_start():
    cfg = _port_tiny()
    params = thash.init_hash_deform(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    x = torch.randn((32, 3), generator=torch.Generator().manual_seed(1))
    d = thash.hash_deform_forward(params, cfg, x, 0.3)
    assert d["d_xyz"].shape == (32, 3)
    assert d["d_rotation"].shape == (32, 4)
    assert d["d_scaling"].shape == (32, 2)
    assert float(d["d_xyz"].detach().abs().max()) < 0.1


def test_facade_dispatch():
    cfg = tdeform.DeformConfig(deform_type="hash", hash=_port_tiny())
    params = tdeform.init_deform(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    x = torch.randn((16, 3), generator=torch.Generator().manual_seed(1))
    d = tdeform.apply_deform_field(params, cfg, x, 0.5, step=100)
    assert d["d_xyz"].shape == (16, 3) and d["d_opacity"] is None


def test_hash_field_fits_translation():
    """The field learns a time-linear translation (the port's Adam, lr
    3e-3, 400 steps: the loss falls below 5% of its start)."""
    cfg = _port_tiny()
    params = thash.init_hash_deform(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    x = torch.rand((256, 3), generator=torch.Generator().manual_seed(2)) \
        * 2.0 - 1.0
    v = torch.tensor([0.3, -0.2, 0.1])
    named = dict(params.named_parameters())
    opt = toptim.adam_init(named)

    def loss_fn(t):
        d = thash.hash_deform_forward(params, cfg, x, t, step=10**9)
        return torch.mean((d["d_xyz"] - t * v[None, :]) ** 2)

    ts = np.linspace(0, 1, 8)
    with torch.no_grad():
        l0 = float(loss_fn(0.7))
    for i in range(400):
        loss = loss_fn(float(ts[i % 8]))
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        opt = toptim.adam_update(dict(zip(named, grads)), opt, named, 3e-3,
                                 eps=1e-8)
    with torch.no_grad():
        l1 = float(loss_fn(0.7))
    assert l1 < l0 * 0.05, (l0, l1)
