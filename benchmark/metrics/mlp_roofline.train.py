"""The deform MLP's products against the card's float32 peak (%): their
least time, 3 x field.mlp_ops (the forward's operations, counted by the
port from the shapes; the backward's two products per layer double
them) / 67 TFLOP/s, over the device time of the traced steps' matrix
products, the own device time of the aten::mm and aten::addmm operators
by launching operator.  None without the counter or the trace.

In mlp-train the field's forward and backward products are nearly all
of those operators' device time: on one H100 (700 W), 14.81 of 14.90 ms
a step went to the products with 200,000 rows, the field's 13 forward
and 25 backward ones (cuBLAS's sm80 xmma and CUTLASS simt SGEMMs, some
split-K); the rest was the normal map by the camera's rotation
([640,000, 3] x [3, 3], forward and backward), 0.09 ms."""
from benchlib import counts
from benchlib.spans import report

MM_OPS = ("aten::mm", "aten::addmm")


def read(ctx) -> float | None:
    tr, rep = ctx.get("trace"), report(ctx)
    if not tr or rep is None:
        return None
    ops = rep["counters"].get("field.mlp_ops")
    sec = sum(v for k, v in tr["op_device_s"].items() if k in MM_OPS)
    if not ops or sec <= 0:
        return None
    return 100.0 * 3.0 * ops / counts.PEAK_F32_FLOPS / sec
