"""The blend's stream time per training step (ms): the d2dgs.blend
span's (packing, the gather, K1, the maps' post-processing)."""
from benchlib.spans import blend_ms as read  # noqa: F401
