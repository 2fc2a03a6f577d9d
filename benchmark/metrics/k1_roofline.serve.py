"""K1 serving: its least time on the sampled views over its mean device
time per launch (%)."""
from benchlib.readers import k1_roofline as read  # noqa: F401
