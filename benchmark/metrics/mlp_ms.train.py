"""The deform MLP's stream time per training step (ms): the d2dgs.mlp
spans' (``mlp_forward``'s encodings, trunk and heads, inside
d2dgs.field).  None where the port has no such span."""
from benchlib.spans import stream_ms


def read(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.mlp",))
