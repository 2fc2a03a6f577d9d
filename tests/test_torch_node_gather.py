"""The node warp's K-neighbour gather (``ops/cuda/node_gather.py``) on
the CPU, where its backward is the plain version: the forward bitwise
aten's indexing, the backward against a float64 sum and aten's indexing
backward, a pile-up of 100,000 rows on three nodes, all-zero gradient
rows, no rows at all, the wrapper's refusals and the trace's counters.
The backward's kernels are held to this on the card in
tests/test_torch_cuda.py.  This file imports torch and d2dgs_torch only."""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.ops.cuda.node_gather import gather_rows

torch.set_num_threads(1)

# the backward against the float64 sum, relative to the gradient's norm
REL = 1e-6


def _case(n, k, m, c, seed=0, pile=0, zero_rows=0.0):
    """table [m, c], idx [n, k] and an upstream gradient [n, k, c]: the
    last ``pile`` rows all bind to nodes (0, 1, 2), as the dead capacity
    rows of a node scene do, and a ``zero_rows`` share of the rows has an
    all-zero gradient."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((m, c), generator=gen)
    idx = torch.randint(0, m, (n, k), generator=gen)
    if pile:
        idx[n - pile:] = torch.arange(k) % m
    g = torch.randn((n, k, c), generator=gen)
    if zero_rows:
        g[torch.rand((n, k), generator=gen) < zero_rows] = 0.0
    return table, idx, g


def _grad(table, idx, g):
    t = table.clone().requires_grad_()
    torch.autograd.backward(gather_rows(t, idx), g)
    return t.grad


def _sum64(idx, g, m):
    """The float64 sum by index, serial, as the reference."""
    return torch.zeros((m, g.shape[-1]), dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, g.shape[-1]).double())


def _assert_rel(got, ref):
    scale = float(torch.linalg.vector_norm(ref))
    err = float(torch.linalg.vector_norm(got.double() - ref))
    assert err <= REL * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("c", [1, 13, 18])
def test_forward_is_aten_indexing_bitwise(c):
    table, idx, _ = _case(500, 3, 37, c)
    out = gather_rows(table, idx)
    assert out.shape == (500, 3, c)
    assert torch.equal(out, table[idx])


@pytest.mark.parametrize("c", [13, 18])
def test_backward_against_float64_and_aten(c):
    table, idx, g = _case(2000, 3, 64, c, seed=1)
    got = _grad(table, idx, g)
    _assert_rel(got, _sum64(idx, g, 64))
    t = table.clone().requires_grad_()
    torch.autograd.backward(t[idx], g)
    _assert_rel(t.grad, _sum64(idx, g, 64))
    torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-5)


def test_pile_of_100000_rows_on_three_nodes():
    """The dead capacity rows' shape: 100,000 rows bound to nodes 0-2,
    with a nonzero gradient here, so the pile's sums are large."""
    n, m = 100_500, 1024
    table, idx, g = _case(n, 3, m, 13, seed=2, pile=100_000)
    got = _grad(table, idx, g)
    ref = _sum64(idx, g, m)
    _assert_rel(got, ref)
    assert float(ref[:3].abs().max()) > 10.0


def test_zero_gradient_rows():
    """Rows whose gradient is all zero add nothing (the kernels skip
    them); a gradient of zeros gives zeros."""
    table, idx, g = _case(3000, 3, 50, 18, seed=3, pile=1000,
                          zero_rows=0.6)
    _assert_rel(_grad(table, idx, g), _sum64(idx, g, 50))
    assert torch.equal(_grad(table, idx, torch.zeros_like(g)),
                       torch.zeros_like(table))


def test_no_rows():
    table = torch.randn(8, 13, requires_grad=True)
    idx = torch.zeros((0, 3), dtype=torch.int64)
    out = gather_rows(table, idx)
    assert out.shape == (0, 3, 13)
    torch.autograd.backward(out, torch.zeros_like(out))
    assert torch.equal(table.grad, torch.zeros(8, 13))


def test_refuses_bad_inputs():
    table, idx, _ = _case(20, 3, 10, 4)
    with pytest.raises(TypeError, match="table"):
        gather_rows(table.double(), idx)
    with pytest.raises(TypeError, match="idx"):
        gather_rows(table, idx.int())
    with pytest.raises(ValueError, match="idx"):
        gather_rows(table, idx.reshape(-1))
    with pytest.raises(ValueError, match="meta"):
        gather_rows(table.to("meta"), idx.to("meta"))
    # an index outside [0, M) reads nothing: aten's forward refuses it
    for bad in (10, -11):
        with pytest.raises(IndexError, match="out of bounds"):
            gather_rows(table, torch.where(idx == idx[0, 0], bad, idx))


def test_counters_under_the_profiler():
    """field.gather_rows counts the gathered rows, field.scatter_rows the
    rows whose gradient was not all zero; nothing counts untraced."""
    table, idx, g = _case(400, 3, 30, 13, seed=4, zero_rows=0.5)
    trace.reset()
    try:
        _grad(table, idx, g)
        assert trace.report()["counters"] == {}
        with profile(activities=[ProfilerActivity.CPU]):
            _grad(table, idx, g)
        c = trace.report()["counters"]
    finally:
        trace.reset()
    assert c["field.gather_rows"] == 1200
    assert c["field.scatter_rows"] == int(torch.any(g != 0, dim=-1).sum())
    assert 0 < c["field.scatter_rows"] < 1200


def test_benchmark_reader_of_the_share():
    """benchmark/metrics/field_bwd_rows_share.train.py: scattered over
    gathered rows (%), None where the port's report lacks the counters (a
    program without this gather) or there is no report."""
    root = Path(__file__).resolve().parents[1] / "benchmark"
    sys.path.insert(0, str(root))
    from benchlib import cells
    read = cells.reader(root / "metrics", "field_bwd_rows_share.train")
    counters = {"field.rows": 400_000, "host.reads": 30,
                "field.gather_rows": 2_400_000,
                "field.scatter_rows": 600_000}
    rep = {"units": 2, "spans": {}, "counters": counters}
    assert read({"trace": {"units": 2}, "spans": rep}) == 25.0
    parent = dict(rep, counters={"field.rows": 400_000, "host.reads": 30})
    assert read({"trace": {"units": 2}, "spans": parent}) is None
    assert read({"trace": {"units": 3}, "spans": rep}) is None
    assert read({"spans": rep}) is None
