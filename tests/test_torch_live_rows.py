"""The deformation field on the live rows only (``models/deform.py``
``deform_gaussians``, its row list ``live_rows``) against the same field
over every row (``apply_deform_field``), for node, mlp, hash and static,
on a mask whose dead rows lie between live ones: the live rows' outputs,
exact zeros on the dead rows, every leaf's gradient, every slot alive
bitwise the every-row field, the row list built once per write to the
mask, and one whole ``main_stage_step``.  On the card (marker ``cuda``): the mlp and
hash fields at the cells' shapes, and no host read once the list is
built.  This file imports torch and d2dgs_torch only:

    python -m pytest tests/test_torch_live_rows.py -q --noconftest -o addopts=""
"""
import types
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.synthetic import make_video_dataset
from d2dgs_torch.models import deform as D
from d2dgs_torch.models.deform_mlp import MLPConfig
from d2dgs_torch.models.hash_deform import HashConfig
from d2dgs_torch.models.nodes import (NodeConfig, init_node_params,
                                      init_nodes_from_pcl)
from d2dgs_torch.train import trainer as T
from d2dgs_torch.train.config import TrainConfig

# one intra-op thread: the suite's worker processes would contend
torch.set_num_threads(1)

TYPES = ["node", "mlp", "hash", "static"]
KEYS = ("d_xyz", "d_rotation", "d_scaling")
TINY_HASH = dict(n_levels=4, log2_hashmap_size=10, base_resolution=4,
                 start_level=2, update_steps=10, num_layers=1, hidden=32,
                 head_width=16)
C, LIVE = 64, 27
STEP = 4_000           # the tiny hash field's band fully open


@pytest.fixture(autouse=True)
def _empty_record():
    trace.reset()
    yield
    trace.reset()


def _raise_heads(mlp, dt):
    """Lift a fresh field off its near-identity init, so that the
    outputs and their gradients are not all near zero."""
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if dt == "hash" and (name.startswith("tables.")
                                 or name == f"mlp.{len(mlp['mlp']) - 1}.w"):
                p.mul_(1e3)
            elif dt != "hash" and name in ("warp.w", "rotation.w"):
                p.mul_(1e3)


def _field(dt, device="cpu", tiny=True):
    """(DeformConfig, the node slot deform_gaussians reads) of type dt."""
    gen = torch.Generator().manual_seed(1)
    mlp = (MLPConfig(is_blender=True, width=32, depth=3) if tiny
           else MLPConfig(is_blender=True))
    cfg = D.DeformConfig(
        deform_type=dt,
        node=NodeConfig(node_num=8, K=3, hyper_dim=2, exact_knn=True,
                        mlp=mlp),
        mlp=mlp, hash=HashConfig(**TINY_HASH) if tiny else HashConfig())
    holder = init_node_params(cfg.node, gen, device=device)
    if dt == "node":
        init_nodes_from_pcl(holder, cfg.node,
                            torch.randn((32, 3), generator=gen) * 0.5,
                            generator=gen)
    elif dt in ("mlp", "hash"):
        holder.mlp = D.init_deform(cfg, gen, device)
    _raise_heads(holder.mlp, dt)
    return cfg, holder


def _scattered(n, live, seed=2, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    alive = torch.zeros(n, dtype=torch.bool)
    alive[torch.randperm(n, generator=gen)[:live]] = True
    return alive.to(device)


def _inputs(n, seed=3, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    xyz = (torch.rand((n, 3), generator=gen) * 2.0 - 1.0).to(device)
    feature = (torch.randn((n, 3), generator=gen) * 0.05).to(device)
    return xyz, feature.requires_grad_(True)


def _call(field, xyz, feature, t, alive=None):
    """``deform_gaussians`` on Gaussians whose slots ``alive`` marks, or,
    with no mask, the field at every row (``apply_deform_field``)."""
    cfg, holder = field
    mm = torch.sigmoid(feature[:, -1:])
    if alive is None:
        params = holder.mlp if cfg.deform_type in ("mlp", "hash") else holder
        return D.apply_deform_field(params, cfg, xyz, t, feature=feature,
                                    motion_mask=mm, step=STEP)
    gauss = types.SimpleNamespace(xyz=xyz, feature=feature, motion_mask=mm,
                                  alive=alive)
    return D.deform_gaussians(holder, cfg, gauss, t, step=STEP)


def _leaves(field, feature):
    cfg, holder = field
    if cfg.deform_type == "node":
        return list(holder.parameters()) + [feature]
    return list(holder.mlp.parameters())


def _grads(field, feature, d, alive, cot):
    """Every leaf's gradient of a loss over the live rows (None where the
    leaf takes none); the rows weighted by the mask, which reads nothing
    back."""
    w = alive[:, None].to(torch.float32)
    loss = sum(torch.sum(d[k] * cot[k] * w) for k in KEYS)
    leaves = _leaves(field, feature)
    if not loss.requires_grad:
        return [None] * len(leaves)
    return list(torch.autograd.grad(loss, leaves, allow_unused=True))


def _max_rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _permute_live_rows(state, perm):
    """The state's Gaussians (leaves and mask) reordered by ``perm``, in
    place, so that the live slots lie scattered over the capacity."""
    g = state.gauss
    with torch.no_grad():
        for k in T.GAUSS_FIELDS:
            p = getattr(g, k)
            p.copy_(p[perm])
        g.alive.copy_(g.alive[perm])


@pytest.mark.parametrize("dt", TYPES)
def test_live_rows_match_every_row(dt, monkeypatch):
    field = _field(dt)
    xyz, feature = _inputs(C)
    alive = _scattered(C, LIVE)
    assert not bool(alive[:8].all()) and bool(alive.any())
    t = torch.tensor(0.3)
    full = _call(field, xyz, feature, t)
    live = _call(field, xyz, feature, t, alive)

    # the live rows as every row's call gives them; the dead rows zero
    for k in KEYS:
        assert live[k].shape == full[k].shape, k
        assert _max_rel(live[k][alive], full[k][alive]) <= 1e-6, k
        assert torch.count_nonzero(live[k][~alive]) == 0, k
    assert [live[k] is None for k in ("d_opacity", "d_color")] == \
        [full[k] is None for k in ("d_opacity", "d_color")]
    moved = float(full["d_xyz"][alive].abs().max())
    assert (moved > 1e-3) == (dt != "static"), moved

    # every leaf's gradient, feature and the motion-mask logits included
    gen = torch.Generator().manual_seed(4)
    cot = {k: torch.randn(full[k].shape, generator=gen) for k in KEYS}
    g_full = _grads(field, feature, full, alive, cot)
    g_live = _grads(field, feature, live, alive, cot)
    assert len(g_full) == len(g_live)
    for i, (a, b) in enumerate(zip(g_live, g_full)):
        assert (a is None) == (b is None), i
        if b is not None and float(b.abs().max()) > 0:
            assert _max_rel(a, b) <= 1e-6, i
    if dt == "node":
        assert float(g_live[-1][:, -1].abs().max()) > 0   # the mask logits
        assert torch.count_nonzero(g_live[-1][~alive]) == 0

    # every slot alive: the every-row field, bitwise
    every = _call(field, xyz, feature, t, torch.ones(C, dtype=torch.bool))
    for k in KEYS:
        assert torch.equal(every[k], full[k]), k

    # the row list: built once per mask and per write to it
    mask = alive.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _call(field, xyz, feature, t, mask)
        c = trace.report()["counters"]
        assert c["field.row_lists"] == 1
        assert c["field.rows"] == 3 * LIVE
        first = int(torch.nonzero(mask)[0])
        mask[first] = False                     # a write in place
        again = _call(field, xyz, feature, t, mask)
    c = trace.report()["counters"]
    assert c["field.row_lists"] == 2
    assert c["field.rows"] == 4 * LIVE - 1
    for k in KEYS:
        assert torch.count_nonzero(again[k][first]) == 0, k
        assert torch.equal(again[k][mask], live[k][mask]), k

    # one whole main-stage step through the live rows and through every
    # row, from the same state with its live slots scattered
    cams, imgs, pts, cols = make_video_dataset(
        3, n_cams=2, n_times=2, H=32, W=32, n_gauss=16, device="cpu")
    cfg = TrainConfig(deform_type=dt, sh_degree=1, hyper_dim=2, node_num=16,
                      gaussian_capacity=512, node_gauss_capacity=256,
                      warm_up=0, raster=RasterConfig(tile_cap=256, chunk=64,
                                                     use_workqueue=False))
    perm = torch.randperm(cfg.gaussian_capacity,
                          generator=torch.Generator().manual_seed(5))
    sched = dict(lambda_normal=0.05, lambda_dist=0.0, lambda_arap=0.01,
                 deform_lr=8e-4, xyz_lr=8e-4, warm=0.0, step=STEP)
    gt = torch.from_numpy(imgs[0])
    out = []
    for every_row in (False, True):
        tr = T.Trainer(cfg, cams, imgs, pts, cols, cameras_extent=4.0,
                       seed=0, device="cpu")
        _raise_heads(tr.state.nodes.mlp, dt)
        _permute_live_rows(tr.state, perm)
        if every_row:
            monkeypatch.setattr(D, "live_rows", lambda alive: None)
        st, m = T.main_stage_step(tr.state, cams[0], gt, cfg, sched)
        out.append((m, {k: v.detach().clone() for k, v in
                        {**T.gauss_trainable(st.gauss),
                         **T.mlp_trainable(st.nodes),
                         **T.node_trainable(st.nodes)}.items()}))
    (m_live, live_leaves), (m_full, full_leaves) = out
    assert float(m_live["loss"]) == pytest.approx(float(m_full["loss"]),
                                                  rel=1e-6)
    assert int(m_live["num_pairs"]) == int(m_full["num_pairs"]) > 0
    for k, v in full_leaves.items():
        torch.testing.assert_close(live_leaves[k], v, rtol=1e-6, atol=1e-7,
                                   msg=k)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["mlp", "hash"])
def test_cell_shapes_on_the_card(dt):
    """The cells' field at their shapes (200,000 slots, 83,252 live and
    scattered): the live rows' outputs and every leaf's gradient against
    every row's call, within float32 GEMM rounding (TF32 off); then, with
    the list built, a call makes no host read the field does not count
    (``host.reads``: the mlp field none, so it runs under sync debug
    mode "error"; the hash field's two copies from host memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, n_live = 200_000, 83_252
    field = _field(dt, device="cuda", tiny=False)
    xyz, feature = _inputs(n, device="cuda")
    alive = _scattered(n, n_live, device="cuda")
    t = torch.tensor(0.3, device="cuda")
    full = _call(field, xyz, feature, t)
    live = _call(field, xyz, feature, t, alive)
    for k in KEYS:
        assert _max_rel(live[k][alive], full[k][alive]) <= 1e-5, k
        assert torch.count_nonzero(live[k][~alive]) == 0, k
    gen = torch.Generator().manual_seed(4)
    cot = {k: torch.randn(full[k].shape, generator=gen).cuda() for k in KEYS}
    g_full = _grads(field, feature, full, alive, cot)
    g_live = _grads(field, feature, live, alive, cot)
    for i, (a, b) in enumerate(zip(g_live, g_full)):
        assert (a is None) == (b is None), i
        if b is not None and float(b.abs().max()) > 0:
            assert _max_rel(a, b) <= 2e-4, i
    torch.cuda.synchronize()

    def step():
        d = _call(field, xyz, feature, t, alive)
        return _grads(field, feature, d, alive, cot)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in got
             if "called a synchronizing CUDA operation" in str(w.message)]
    c = trace.report()["counters"]
    assert c.get("field.row_lists", 0) == 0
    assert c["field.rows"] == n_live
    assert len(syncs) == c.get("host.reads", 0), syncs
    assert not [s for s in syncs if s.endswith(("deform.py", "trace.py"))]
    if dt == "mlp":
        assert not syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
