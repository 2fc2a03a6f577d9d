"""The HexPlane field's plane sampling against the card's bounds (%): its
least time a step, ``counts.least_seconds`` of
``fields/hexplane.py`` ``sample_work`` for field.plane_samples / 12 rows
a step (the port's count of its plane samples), over the own device time
a step of the operators that sample the planes and accumulate their
gradient, by operator.  The least time is the bytes' (the planes read
and their gradient written once, each row's coordinates, features and
feature gradient) at 3.35 TB/s.  None without the counter or the
trace."""
from benchlib import counts
from benchlib.fields import hexplane
from benchlib.spans import report

SAMPLE_OPS = ("aten::grid_sampler_2d", "aten::grid_sampler_2d_backward")


def read(ctx) -> float | None:
    tr, rep = ctx.get("trace"), report(ctx)
    if not tr or rep is None:
        return None
    samples = rep["counters"].get("field.plane_samples")
    sec = sum(v for k, v in tr["op_device_s"].items() if k in SAMPLE_OPS)
    if not samples or sec <= 0:
        return None
    units = tr["units"]
    cfg = ctx["cfg"]
    rows = samples / hexplane.samples_per_row(cfg) / units
    work = hexplane.sample_work(cfg, rows)
    return 100.0 * counts.least_seconds(work) / (sec / units)
