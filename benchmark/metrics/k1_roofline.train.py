"""K1 in training mode: its least time on the traced steps' views over
its mean device time per launch (%)."""
from benchlib.readers import k1_roofline as read  # noqa: F401
