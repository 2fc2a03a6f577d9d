"""Spans and counters of the port, on exactly while a ``torch.profiler``
records (``cli train --profile N``, the benchmark's traced segment, the
profiling tools); otherwise each call is one check of the profiler's
flag.

    with trace.span("d2dgs.field"):       # one layer of a step or a view
        trace.count("field.rows", n)      # a host int or a 0-d tensor
    ...
    rep = trace.report()                  # after the profiled units

A span enters a profiler range under its name (the operator-scope
``RecordFunction`` that ``torch.profiler`` traces on the CPU beside the
aten operators: ``record_function``'s user scope would also put a
device-side range in the trace, which a trace's reduction then counts as
device work), so it lies in the profiler's trace on the kernels' clock
and encloses the launches made inside it, and keeps a record in memory:
its name, its unit (the root span's number: spans of one step or one
view share it), its parent (from a per-thread stack) and its host start
and end (``time.perf_counter_ns``).  Once CUDA is initialised in the
process it also records a CUDA event on the current stream at its entry
and at its exit.  The records stay in memory until ``reset``; the
profiler's own chrome trace is the export.

The spans of the port, from the root down: ``d2dgs.step`` (a training
step) or ``d2dgs.view`` (a served view); ``d2dgs.pick``,
``d2dgs.field``, ``d2dgs.project``, ``d2dgs.bin``, ``d2dgs.blend``,
``d2dgs.loss``, ``d2dgs.backward``, ``d2dgs.adam``, ``d2dgs.maintain``;
below them ``d2dgs.mlp`` (the deform MLP's encodings, trunk and heads,
``models/deform_mlp.py`` ``mlp_forward``: inside ``d2dgs.field``, and
inside ``d2dgs.loss`` where the node ARAP term queries it).
The counters: ``field.rows`` (rows the deformation field evaluated:
the live ones where its caller passes the mask), ``field.row_lists``
(the live-row lists ``models/deform.py`` ``live_rows`` built),
``render.live`` (live surfels rendered), ``host.reads`` (places where
the host waited on a CUDA device: a value read back, or a copy from
pageable host memory, which waits for the stream), ``field.gather_rows``
and ``field.scatter_rows`` (rows the node warp's K-neighbour gathers
gathered, and those whose gradient their backward accumulated, not all
zero; ``ops/cuda/node_gather.py``), ``field.mlp_ops`` (the deform MLP
forward's float operations, 2 * rows * the sum of fan_in * fan_out over
its products, counted from the shapes), ``adam.leaves`` and
``adam.kernel_leaves`` (the leaves Adam updated, and those its kernel
updated; ``train/optim.py``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# open and closed spans: [name, unit, parent record, start ns, end ns
# (0 while open), entry event, exit event]
_records: list = []
# name -> [host total, 0-d device tensors summed by report()]
_counters: dict = {}
_local = threading.local()
_units = itertools.count()


class SpanRecord(NamedTuple):
    name: str
    unit: int              # the number of the unit's root span
    parent: int | None     # index in records() of the enclosing span
    start_ns: int          # host clock, time.perf_counter_ns
    end_ns: int            # 0 while the span is open


def enabled() -> bool:
    """Whether spans and counters record: while a torch.profiler does."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_rf", "_rec", "_stack")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        unit = next(_units) if parent is None else parent[1]
        self._rf = torch._C._profiler._RecordFunctionFast(self._name)
        self._rf.__enter__()
        ev = None
        if torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        rec = [self._name, unit, parent, time.perf_counter_ns(), 0, ev, None]
        _records.append(rec)
        stack.append(rec)
        self._rec, self._stack = rec, stack
        return None

    def __exit__(self, *exc):
        rec = self._rec
        if rec[5] is not None:
            rec[6] = torch.cuda.Event(enable_timing=True)
            rec[6].record()
        rec[4] = time.perf_counter_ns()
        self._stack.pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over one layer's work: the shared no-op unless
    a torch.profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Adds ``value`` to counter ``name`` while a torch.profiler records.
    A 0-d tensor is kept as it is and summed by ``report``, so nothing is
    read back from the device here."""
    if not _profiler._is_profiler_enabled:
        return
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = [0, []]
    if isinstance(value, torch.Tensor):
        c[1].append(value.detach())
    else:
        c[0] += value


def records() -> list[SpanRecord]:
    """The spans recorded since the last ``reset``, in order of entry."""
    index = {id(r): i for i, r in enumerate(_records)}
    return [SpanRecord(r[0], r[1], None if r[2] is None
                       else index.get(id(r[2])), r[3], r[4])
            for r in _records]


def report() -> dict:
    """Synchronises the device once (where spans recorded events) and
    sums the closed spans by name: ``units`` (root spans), ``spans``
    {name: count, host_ms, host_self_ms (less its child spans' host
    time), stream_ms (the time between its two events on the stream,
    None without them), parents (the enclosing spans' names)} and
    ``counters`` {name: total}."""
    recs = [r for r in _records if r[4]]
    if any(r[5] is not None for r in recs):
        torch.cuda.synchronize()
    child_ns = {}
    for r in recs:
        if r[2] is not None:
            child_ns[id(r[2])] = child_ns.get(id(r[2]), 0) + r[4] - r[3]
    spans = {}
    for r in recs:
        s = spans.get(r[0])
        if s is None:
            s = spans[r[0]] = dict(count=0, host_ms=0.0, host_self_ms=0.0,
                                   stream_ms=0.0, parents=set())
        ns = r[4] - r[3]
        s["count"] += 1
        s["host_ms"] += ns / 1e6
        s["host_self_ms"] += (ns - child_ns.get(id(r), 0)) / 1e6
        if r[5] is None or s["stream_ms"] is None:
            s["stream_ms"] = None
        else:
            s["stream_ms"] += r[5].elapsed_time(r[6])
        if r[2] is not None:
            s["parents"].add(r[2][0])
    for s in spans.values():
        s["parents"] = sorted(s["parents"])
    counters = {name: host + sum(t.item() for t in dev)
                for name, (host, dev) in _counters.items()}
    return dict(units=sum(1 for r in recs if r[2] is None), spans=spans,
                counters=counters)


def reset() -> None:
    """Empties the record of spans and counters."""
    _records.clear()
    _counters.clear()
