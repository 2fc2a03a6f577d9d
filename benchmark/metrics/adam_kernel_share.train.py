"""Leaves of the Adam groups that the port's Adam kernel updated, over all
the leaves Adam updated, in the traced training steps (%): 100 *
adam.kernel_leaves / adam.leaves.  None where the port counts neither."""
from benchlib.spans import report


def read(ctx) -> float | None:
    rep = report(ctx)
    if rep is None:
        return None
    kernel = rep["counters"].get("adam.kernel_leaves")
    leaves = rep["counters"].get("adam.leaves")
    if kernel is None or not leaves:
        return None
    return 100.0 * kernel / leaves
