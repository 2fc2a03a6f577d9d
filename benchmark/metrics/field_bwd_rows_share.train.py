"""Rows of the node warp's K-neighbour gathers whose gradient the backward
accumulated (not all zero), over the rows the forward gathered, in the
traced training steps (%): 100 * field.scatter_rows / field.gather_rows.
None where the port counts neither."""
from benchlib.spans import report


def read(ctx) -> float | None:
    rep = report(ctx)
    if rep is None:
        return None
    scattered = rep["counters"].get("field.scatter_rows")
    gathered = rep["counters"].get("field.gather_rows")
    if scattered is None or not gathered:
        return None
    return 100.0 * scattered / gathered
