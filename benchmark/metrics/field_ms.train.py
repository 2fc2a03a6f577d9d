"""The deformation field's stream time per training step (ms): the
d2dgs.field span's, from its entry event to its exit event."""
from benchlib.spans import field_ms as read  # noqa: F401
