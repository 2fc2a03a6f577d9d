"""Places where the host waited on the device per served view: the
host.reads counter over the traced views."""
from benchlib.spans import host_reads_per_unit as read  # noqa: F401
