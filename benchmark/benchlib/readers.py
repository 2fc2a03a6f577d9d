"""What the per-layer readers under ``metrics/`` share.  ``ctx`` is a
run's output (``drive.run_train``/``run_serve``) of a traced run with
the cell's ``cfg`` and ``traffic``: ``trace`` (``tracing.reduce``),
``counters`` (the port's K1/K2 launch counters over the traced segment),
``walk`` (the plain reference's walk counts per view), ``unit_s`` (the
untraced window's seconds per step or view) and ``n_live``.  A reader
that finds nothing to read returns None."""
from __future__ import annotations

from . import counts, tracing

# K1 (csrc/blend_fwd.cu: the layout kernel, pass A, pass B) and K2
# (csrc/blend_bwd.cu) by kernel name
K1_KERNELS = ("fwd_layout", "fwd_pass_a", "fwd_pass_b")
K2_KERNELS = ("blend_bwd_kernel",)
# PyTorch's advanced-indexing backward: the operators whose own device
# time it is (the sort of the indices and the accumulation kernels)
INDEX_BWD_OPS = ("aten::_index_put_impl_", "aten::index_put_",
                 "aten::index_put")


def idle_share(ctx) -> float | None:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def launches_per_unit(ctx) -> float | None:
    tr = ctx.get("trace")
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["units"]


def index_bwd_ms(ctx) -> float | None:
    tr = ctx.get("trace")
    if not tr:
        return None
    s = sum(v for k, v in tr["op_device_s"].items() if k in INDEX_BWD_OPS)
    return s / tr["units"] * 1e3 if s > 0 else None


def roofline(ctx, kernels: tuple, counter: str, work) -> float | None:
    """A kernel's least time over its mean device time per launch (%)."""
    tr, walk = ctx.get("trace"), ctx.get("walk")
    n = (ctx.get("counters") or {}).get(counter, 0)
    if not tr or not walk or not n:
        return None
    sec = tracing.kernel_seconds(tr, kernels)
    if sec <= 0:
        return None
    return 100.0 * counts.least_seconds(work(walk)) / (sec / n)


def k1_roofline(ctx) -> float | None:
    train = ctx["kind"] == "train"
    return roofline(ctx, K1_KERNELS, "k1_launches",
                    lambda w: counts.blend_fwd(w, train))


def k2_roofline(ctx) -> float | None:
    return roofline(ctx, K2_KERNELS, "k2_launches", counts.blend_bwd)


def mfu(ctx) -> float | None:
    walk, unit_s = ctx.get("walk"), ctx.get("unit_s")
    if not walk or not unit_s:
        return None
    cfg, tf = ctx["cfg"], ctx["traffic"]
    if ctx["kind"] == "train":
        ops = counts.train_step_ops(cfg, walk, ctx["n_live"], tf["height"],
                                    tf["width"])
    else:
        ops = counts.view_ops(cfg, walk, ctx["n_live"])
    return 100.0 * ops / unit_s / counts.PEAK_F32_FLOPS
