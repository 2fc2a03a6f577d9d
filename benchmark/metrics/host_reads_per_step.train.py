"""Places where the host waited on the device per training step: the
host.reads counter over the traced steps."""
from benchlib.spans import host_reads_per_unit as read  # noqa: F401
