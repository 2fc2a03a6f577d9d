"""A whole served view's float32 operations over the untraced view time
and the card's float32 peak (%)."""
from benchlib.readers import mfu as read  # noqa: F401
