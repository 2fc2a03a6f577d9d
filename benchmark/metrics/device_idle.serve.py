"""The device's idle share of the traced served views (%): 1 - the
device's busy time / the traced window's wall time."""
from benchlib.readers import idle_share as read  # noqa: F401
