"""The whole main-stage step's float32 operations over the untraced step
time and the card's float32 peak (%)."""
from benchlib.readers import mfu as read  # noqa: F401
