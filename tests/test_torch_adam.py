"""Adam (``train/optim.py`` ``adam_update``) and its kernel
(``csrc/adam.cu``, ``ops/cuda/adam.py``).  On the CPU: CPU tensors take
the plain version, bitwise ``adam_update_plain``, with no launch; the
leaf lists of the launches; the counters; ``leaf_fits`` on every leaf
and gradient of tiny training steps of each field, and its refusals.
On the card (marked ``cuda``, skipped where torch.cuda.is_available()
is False): the kernel bitwise the plain version over three steps of the
three groups at node-train's, hash-train's and mlp-train's shapes, a
group whose leaf list spans three launches, a strided gradient on the
kernel and every leaf it cannot take refused by name, the bias
corrections bitwise aten's, and a step under
``torch.cuda.set_sync_debug_mode("error")``.  The groups come from
``tools/adam_time.py`` (``groups_of``, ``clone``).  This file imports
torch, numpy, d2dgs_torch and that tool only, so it also runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_adam.py -q --noconftest -o addopts=""
"""
import ctypes
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.ops.cuda import adam as adam_cuda
from d2dgs_torch.train import optim
from d2dgs_torch.data.synthetic import make_video_dataset
from d2dgs_torch.train import trainer as T
from d2dgs_torch.train.config import TrainConfig
from torch_tiny import TINY

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from adam_time import clone, groups_of  # noqa: E402

torch.set_num_threads(1)

B1, B2 = 0.9, 0.999


@pytest.fixture(autouse=True)
def _empty_record():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _groups(deform_type, dev, **sizes):
    """The three parameter groups of a TrainState (the cells' widths at
    the default capacity) and their AdamStates."""
    return groups_of(deform_type, dev, **sizes)[:2]


def _grads(group, step, seed):
    """A gradient a leaf, a tenth of each exactly zero, smaller each
    step; the group's first leaf has none (None)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, (k, p) in enumerate(group.items()):
        if i == 0:
            out[k] = None
            continue
        g = torch.randn(p.shape, generator=gen) * 10.0 ** -step
        g[torch.rand(p.shape, generator=gen) < 0.1] = 0.0
        out[k] = g.to(p.device)
    return out


def _lrs(group, step):
    """Per-name learning rates that change every step."""
    return {k: 1e-3 * (1 + i) * (1 + 0.37 * step)
            for i, k in enumerate(group)}


def _assert_same(a_groups, a_opts, b_groups, b_opts):
    for ga, oa, gb, ob in zip(a_groups, a_opts, b_groups, b_opts):
        assert torch.equal(oa.count, ob.count)
        for k in ga:
            for x, y, what in ((ga[k], gb[k], "param"), (oa.mu[k], ob.mu[k],
                               "mu"), (oa.nu[k], ob.nu[k], "nu")):
                assert torch.equal(x, y), (what, k, float(
                    (x - y).abs().max()))


def _steps(groups, opts, ref_groups, ref_opts, n=3, lr_of=_lrs,
           grads_of=_grads):
    """n steps of the groups by adam_update and of the copies by
    adam_update_plain, on the same gradients; the launches a step."""
    launches = []
    for step in range(n):
        before = adam_cuda.adam_step.launches
        for i, (g, rg) in enumerate(zip(groups, ref_groups)):
            grads = grads_of(g, step, seed=10 * step + i)
            lr = lr_of(g, step)
            opts[i] = optim.adam_update(grads, opts[i], g, lr)
            ref_opts[i] = optim.adam_update_plain(grads, ref_opts[i], rg, lr)
        launches.append(adam_cuda.adam_step.launches - before)
    return launches


# ------------------------------------------------------------------ CPU

def test_cpu_takes_the_plain_version():
    """CPU tensors: bitwise adam_update_plain over three steps with a
    missing gradient and changing per-name rates, and no launch."""
    groups, opts = _groups("node", "cpu", capacity=4000, n_points=2000)
    ref_groups, ref_opts = clone(groups, opts)
    launches = _steps(groups, opts, ref_groups, ref_opts)
    assert launches == [0, 0, 0]
    _assert_same(groups, opts, ref_groups, ref_opts)
    assert int(opts[0].count) == 3


@pytest.mark.parametrize("deform_type", ["node", "hash", "mlp"])
def test_trainer_steps_fit_the_kernel(deform_type, monkeypatch):
    """Every leaf of two tiny main-stage steps' three groups, with its
    moments and gradient, is one the kernel takes (leaf_fits), so on the
    card the kernel updates all of them; each group fits one launch."""
    cfg = dataclasses.replace(TINY, deform_type=deform_type)
    cams, imgs, pts, cols = make_video_dataset(
        3, n_cams=2, n_times=2, H=32, W=32, n_gauss=16, device="cpu")
    tr = T.Trainer(cfg, cams, imgs, pts, cols, cameras_extent=4.0, seed=0,
                   device="cpu")
    tr.iteration_node = cfg.iterations_node_rendering
    seen = []

    def spy(grads, state, params, lr):
        seen.append([adam_cuda.leaf_fits(lf, state.count)
                     for lf in optim._leaves(grads, state, params, lr)])
        return optim.adam_update(grads, state, params, lr)

    monkeypatch.setattr(T, "adam_update", spy)
    tr.step()
    tr.step()
    assert len(seen) == 6 and all(seen), seen
    assert max(len(s) for s in seen) <= adam_cuda.MAX_LEAVES


def test_leaf_lists_of_the_launches():
    """pack: MAX_LEAVES leaves a launch in order, a missing gradient a
    null pointer, the rate rounded to float32 as aten rounds a scalar."""
    n = 2 * adam_cuda.MAX_LEAVES + 22
    leaves = []
    for i in range(n):
        p = torch.zeros(1 + i % 7)
        g = None if i % 5 == 0 else torch.zeros(1 + i % 7)
        leaves.append(adam_cuda.Leaf(p, g, torch.zeros(1 + i % 7),
                                     torch.zeros(1 + i % 7), 0.1 * (i + 1)))
    lists = adam_cuda.pack(leaves)
    assert [lst.n for lst in lists] == [adam_cuda.MAX_LEAVES,
                                        adam_cuda.MAX_LEAVES, 22]
    for j, lf in enumerate(leaves):
        lst, i = lists[j // adam_cuda.MAX_LEAVES], j % adam_cuda.MAX_LEAVES
        assert lst.p[i] == lf.p.data_ptr() and lst.m[i] == lf.m.data_ptr()
        assert lst.v[i] == lf.v.data_ptr()
        assert lst.g[i] == (None if lf.g is None else lf.g.data_ptr())
        assert lst.numel[i] == lf.p.numel()
        assert lst.lr[i] == float(np.float32(lf.lr))
    # csrc/adam.cu's AdamLeaves: 4 pointer arrays, numel, tile_end, lr, n
    m = adam_cuda.MAX_LEAVES
    assert ctypes.sizeof(adam_cuda._Leaves) == 8 * (4 * m + m) \
        + 4 * (2 * m) + 8


def test_counters_of_a_group():
    """Under a profiler: adam.leaves counts the group's leaves,
    adam.kernel_leaves those the kernel updated (none on the CPU)."""
    params = {"a": torch.ones(3), "b": torch.ones(2, 2), "c": torch.ones(1)}
    state = optim.adam_init(params)
    with profile(activities=[ProfilerActivity.CPU]):
        optim.adam_update({"a": torch.ones(3), "b": None,
                           "c": torch.ones(1)}, state, params, 1e-3)
    c = trace.report()["counters"]
    assert c["adam.leaves"] == 3 and c["adam.kernel_leaves"] == 0
    assert c["host.reads"] == 2


def test_kernel_refuses_what_it_cannot_take():
    """leaf_fits: float32 p, m, v, contiguous and of one shape, a gradient
    of that shape in any layout or None, a Python rate, an int32 count."""
    count = torch.ones((), dtype=torch.int32)
    z = lambda *s: torch.zeros(s)
    lf = adam_cuda.Leaf(z(4, 3), z(4, 3), z(4, 3), z(4, 3), 1e-3)
    assert adam_cuda.leaf_fits(lf, count)
    assert adam_cuda.leaf_fits(lf._replace(g=None), count)
    assert adam_cuda.leaf_fits(lf._replace(g=z(3, 4).t()), count)
    for bad in (lf._replace(p=z(3, 4).t()), lf._replace(m=z(12)),
                lf._replace(v=z(4, 3).double()), lf._replace(g=z(4, 3).half()),
                lf._replace(g=z(12)), lf._replace(lr=torch.tensor(1e-3))):
        assert not adam_cuda.leaf_fits(bad, count)
    assert not adam_cuda.leaf_fits(lf, count.long())


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("deform_type", ["node", "hash", "mlp"])
def test_kernel_bitwise_plain_at_cell_shapes(cuda, deform_type):
    """The three groups at the cells' widths (200,000 slots; the node
    field's MLP and nodes, the hash field's twelve 2^19 x 2 tables and
    MLP, or the 8x256 MLP field), a missing gradient in each group, per-name rates that change
    every step: three steps of the kernel bitwise the plain version's,
    params, moments and count; one launch a group a step; every leaf to
    the kernel."""
    groups, opts = _groups(deform_type, cuda)
    ref_groups, ref_opts = clone(groups, opts)
    with profile(activities=[ProfilerActivity.CPU]):
        launches = _steps(groups, opts, ref_groups, ref_opts)
    torch.cuda.synchronize()
    assert launches == [3, 3, 3]
    _assert_same(groups, opts, ref_groups, ref_opts)
    c = trace.report()["counters"]
    n = sum(len(g) for g in groups)
    assert c["adam.leaves"] == c["adam.kernel_leaves"] == 3 * n


@pytest.mark.cuda
def test_group_spanning_three_launches(cuda):
    """150 leaves of 0 to 5,000 elements (tails of a tile, a leaf off a
    16-byte boundary, missing gradients): bitwise the plain version over
    two steps, three launches a step."""
    gen = torch.Generator().manual_seed(3)
    sizes = [0, 1, 3, 4, 1023, 1024, 1025, 4096, 4099, 5000]
    group = {f"w{i}": torch.randn(sizes[i % len(sizes)], generator=gen).to(
        cuda) for i in range(150)}
    group["w7"] = torch.randn(4097, generator=gen).to(cuda)[1:]
    assert group["w7"].data_ptr() % 16 != 0
    opts = [optim.adam_init(group)]
    groups = [group]
    ref_groups, ref_opts = clone(groups, opts)
    launches = _steps(groups, opts, ref_groups, ref_opts, n=2)
    torch.cuda.synchronize()
    assert launches == [3, 3]
    _assert_same(groups, opts, ref_groups, ref_opts)


@pytest.mark.cuda
def test_card_refuses_leaves_the_kernel_cannot_take(cuda):
    """A leaf whose gradient is strided (a slice, as autograd gives the SH
    features') goes to the kernel: bitwise the plain version over two
    steps, one launch each.  A strided parameter, a float64 leaf or a
    tensor rate in the group raises ValueError naming that leaf, before
    any leaf or moment is written."""
    gen = torch.Generator().manual_seed(4)
    group = {"a": torch.randn(300, 7, generator=gen).to(cuda),
             "s": torch.randn(300, 15, 3, generator=gen).to(cuda),
             "b": torch.randn(2000, generator=gen).to(cuda)}
    opts = [optim.adam_init(group)]
    groups = [group]
    ref_groups, ref_opts = clone(groups, opts)

    def grads(g, step, seed):
        out = _grads(g, step, seed)
        out["s"] = torch.randn(300, 16, 3, generator=gen).to(cuda)[:, 1:]
        assert not out["s"].is_contiguous()
        return out

    with profile(activities=[ProfilerActivity.CPU]):
        launches = _steps(groups, opts, ref_groups, ref_opts, n=2,
                          grads_of=grads)
    torch.cuda.synchronize()
    assert launches == [1, 1]
    _assert_same(groups, opts, ref_groups, ref_opts)
    c = trace.report()["counters"]
    assert c["adam.leaves"] == c["adam.kernel_leaves"] == 2 * 3
    # only the oracle's (adam_update_plain's) two copies a step
    assert c["host.reads"] == 2 * 2

    bad = {"t": torch.randn(7, 300, generator=gen).to(cuda).t(),
           "d": torch.randn(50, generator=gen, dtype=torch.float64).to(cuda),
           "r": torch.randn(40, generator=gen).to(cuda)}
    assert not bad["t"].is_contiguous()
    for k, leaf in bad.items():
        params = {**group, k: leaf}
        state = optim.adam_init(params)
        lr = {n: 1e-3 for n in params}
        if k == "r":
            lr[k] = torch.tensor(1e-3, device=cuda)
        before = [t.clone() for t in (*params.values(), *state.mu.values())]
        g = {n: torch.ones_like(p) for n, p in params.items()}
        with pytest.raises(ValueError, match=f"leaf '{k}'"):
            optim.adam_update(g, state, params, lr)
        after = (*params.values(), *state.mu.values())
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        assert int(state.count) == 0


@pytest.mark.cuda
def test_bias_corrections_bitwise_aten(cuda):
    """The kernel's 1 - b^t (powf on the card) against the plain version's
    1 - torch.pow(torch.tensor(b), t), at the counts of a whole schedule
    and beyond."""
    counts = list(range(1, 2001)) + list(range(2001, 200_001, 997)) \
        + [60_001, 80_000, 10**6, 2**31 - 1]
    bad = []
    for t in counts:
        count = torch.tensor(t, dtype=torch.int32, device=cuda)
        got = adam_cuda.adam_corrections(count, B1, B2)
        tf = count.to(torch.float32)
        want = torch.stack([
            1.0 - torch.pow(torch.tensor(b, dtype=torch.float32, device=cuda),
                            tf) for b in (B1, B2)])
        if not torch.equal(got, want):
            bad.append((t, got.tolist(), want.tolist()))
    assert not bad, bad[:10]


@pytest.mark.cuda
def test_step_without_host_sync(cuda):
    """adam_update of the hash field's three groups under
    torch.cuda.set_sync_debug_mode("error"): no read back, no copy from
    host memory."""
    groups, opts = _groups("hash", cuda)
    grads = [_grads(g, 0, seed=i) for i, g in enumerate(groups)]
    adam_cuda._lib()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, g in enumerate(groups):
            opts[i] = optim.adam_update(grads[i], opts[i], g, _lrs(g, 0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(int(o.count) == 1 for o in opts)
