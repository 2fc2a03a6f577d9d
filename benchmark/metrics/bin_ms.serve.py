"""Projection and binning's stream time per served view (ms): the
d2dgs.project and d2dgs.bin spans'."""
from benchlib.spans import bin_ms as read  # noqa: F401
