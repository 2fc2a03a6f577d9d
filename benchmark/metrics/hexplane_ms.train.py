"""The HexPlane field's stream time per training step (ms): the
d2dgs.hexplane spans' (``hexplane_forward``'s plane sampling, products
and MLP, inside d2dgs.field).  None where the port has no such span."""
from benchlib.spans import stream_ms


def read(ctx) -> float | None:
    return stream_ms(ctx, ("d2dgs.hexplane",))
