"""The per-layer readers of the port's own spans and counters
(``d2dgs_torch.trace``): the spans record while the traced segment's
profiler does, and ``trace.report()`` is read once, after it.  Beside
``program``, this is the one module of the benchmark that imports the
port, and it imports only ``d2dgs_torch.trace``.  Where the port has no
such module, or its report does not count the traced segment's units
(``ctx["trace"]["units"]``), every reader returns None.

A ``*_ms`` metric is its spans' ``stream_ms`` per unit: the time between
the CUDA events at the spans' entry and exit, so the layer's kernels and
the device's waits for the host inside it.  The report is kept in the
run's ``ctx`` under ``"spans"``."""
from __future__ import annotations

import json
import sys


def report(ctx) -> dict | None:
    """The port's report of the traced segment, read once and kept in
    ``ctx["spans"]``; None where there is none or it does not count the
    traced units."""
    tr = ctx.get("trace")
    if not tr:
        return None
    if "spans" not in ctx:
        try:
            from d2dgs_torch import trace
        except ImportError:
            ctx["spans"] = None
        else:
            ctx["spans"] = trace.report()
            print(f"spans: {json.dumps(ctx['spans'])}", file=sys.stderr,
                  flush=True)
    rep = ctx["spans"]
    if rep is None or rep["units"] != tr["units"]:
        return None
    return rep


def stream_ms(ctx, names: tuple) -> float | None:
    """The spans ``names``' stream time per unit (ms)."""
    rep = report(ctx)
    if rep is None:
        return None
    spans = [rep["spans"].get(n) for n in names]
    if any(s is None or s["stream_ms"] is None for s in spans):
        return None
    return sum(s["stream_ms"] for s in spans) / rep["units"]


def field_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.field",))


def bin_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.project", "d2dgs.bin"))


def blend_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.blend",))


def loss_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.loss",))


def backward_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.backward",))


def adam_ms(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.adam",))


def field_live_share(ctx) -> float | None:
    """Live surfels rendered over the rows the field evaluated (%)."""
    rep = report(ctx)
    if rep is None:
        return None
    rows = rep["counters"].get("field.rows")
    live = rep["counters"].get("render.live")
    if not rows or live is None:
        return None
    return 100.0 * live / rows


def host_reads_per_unit(ctx) -> float | None:
    """The places a unit's host waited on the device, per unit."""
    rep = report(ctx)
    if rep is None:
        return None
    return rep["counters"].get("host.reads", 0) / rep["units"]
