"""CUDA kernels launched per training step (the traced steps)."""
from benchlib.readers import launches_per_unit as read  # noqa: F401
