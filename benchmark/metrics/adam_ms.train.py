"""Adam's stream time per training step (ms): the d2dgs.adam spans'
(the three groups' updates and the densify statistics)."""
from benchlib.spans import adam_ms as read  # noqa: F401
