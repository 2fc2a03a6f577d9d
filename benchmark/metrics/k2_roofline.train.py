"""K2: its least time on the traced steps' views over its mean device
time per launch (%)."""
from benchlib.readers import k2_roofline as read  # noqa: F401
