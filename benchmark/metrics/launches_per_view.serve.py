"""CUDA kernels launched per served view (the traced views)."""
from benchlib.readers import launches_per_unit as read  # noqa: F401
