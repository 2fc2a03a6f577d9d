"""The node warp's K-neighbour gather, ``gather_rows(table [M, C], idx
[N, K]) -> [N, K, C]``, differentiable in ``table``, and the wrapper of
its backward's kernels in ``csrc/node_gather.cu``.

The forward is aten's indexing, ``table[idx]``.  On CUDA tensors the
backward is ``node_gather_bwd_launch``: each block sums its slab of
gradient rows into an [M, C] tile in shared memory, skipping rows that
are all zero, then one launch sums the blocks' tiles in a fixed order, so
the table's gradient has the same bits on every run.  On CPU tensors it is
the plain version below, ``scatter_rows_plain`` (``index_add_`` in
float64).

While the port's trace records (``d2dgs_torch.trace``), the forward adds
N*K to the counter ``field.gather_rows`` and the backward the entries it
accumulated, those whose gradient row is not all zero, to
``field.scatter_rows``.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from . import build

SOURCE = "node_gather.cu"
LIB = build.Library(SOURCE, {"node_gather_bwd_plan": "qiip",
                             "node_gather_bwd_launch": "ppqiip pppp"})


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Plain version of the backward: the [m, C] sum of the rows of
    g [N, K, C] by their index in idx [N, K], taken in float64 and rounded
    once (a serial float32 sum over a node's ~100,000 rows would drift
    by ~1e-6 of the gradient's norm)."""
    c = g.shape[-1]
    acc = torch.zeros((m, c), dtype=torch.float64, device=g.device)
    return acc.index_add_(0, idx.reshape(-1),
                          g.reshape(-1, c).double()).to(g.dtype)


def bwd_plan(n_entries: int, m: int, c: int) -> tuple[int, int, int]:
    """The backward's grid on the current CUDA device: (blocks, column
    chunks, columns per chunk).  One chunk unless the [m, c] tile does not
    fit a block's shared memory; raises where one column of m rows does
    not fit either."""
    plan = (ctypes.c_int * 3)()
    LIB.call("node_gather_bwd_plan", n_entries, m, c, ctypes.addressof(plan))
    if plan[2] < 1:
        raise ValueError(f"{m} nodes: one column of the node tile does not "
                         "fit a block's shared memory")
    return tuple(plan)


def gather_bwd(g: torch.Tensor, idx: torch.Tensor, m: int,
               n_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The backward kernels: g [N, K, C] float32 and idx [N, K] int64,
    contiguous on one CUDA device -> the [m, C] sum of g's rows by index;
    an entry whose index is outside [0, m) adds nothing.  ``n_rows``
    (optional int64, one element, on that device) is incremented by the
    entries in range whose row was not all zero."""
    c = g.shape[-1]
    n = idx.numel()
    if not n or not m * c:
        return torch.zeros((m, c), dtype=g.dtype, device=g.device)
    grad = torch.empty((m, c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        plan = bwd_plan(n, m, c)
    partials = torch.empty((plan[0], m, c), dtype=g.dtype, device=g.device)
    plan_c = (ctypes.c_int * 3)(*plan)
    LIB.launch("node_gather_bwd_launch", g.device, g, idx, n, m, c,
               ctypes.addressof(plan_c), partials, grad, n_rows)
    gather_bwd.launches += 1
    return grad


gather_bwd.launches = 0


class GatherRows(torch.autograd.Function):
    """table[idx] with the backward above."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.m = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        g = g.contiguous()
        counting = trace.enabled()
        if g.device.type == "cpu":
            grad = scatter_rows_plain(g, idx, ctx.m)
            if counting:
                trace.count("field.scatter_rows",
                            torch.sum(torch.any(g != 0, dim=-1)))
            return grad, None
        n_rows = (torch.zeros(1, dtype=torch.int64, device=g.device)
                  if counting else None)
        grad = gather_bwd(g, idx, ctx.m, n_rows)
        if counting:
            trace.count("field.scatter_rows", n_rows[0])
        return grad, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [M, C] float32, idx [N, K] int64 on the same device (CPU or
    CUDA) -> table[idx], [N, K, C], differentiable in ``table``.  Raises on
    another dtype, rank or device; an index outside [0, M) fails in aten's
    forward (IndexError on the CPU, a device-side assertion on CUDA)."""
    dev = table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows runs on cpu or cuda, not {dev}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, expected {dev}")
    if table.dtype != torch.float32:
        raise TypeError(f"table has dtype {table.dtype}, expected "
                        "torch.float32")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx has dtype {idx.dtype}, expected torch.int64")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table [M, C] and idx [N, K] expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    trace.count("field.gather_rows", idx.numel())
    return GatherRows.apply(table, idx.contiguous())
