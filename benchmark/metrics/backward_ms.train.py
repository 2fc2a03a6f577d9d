"""The autograd backward's stream time per training step (ms): the
d2dgs.backward span's (torch.autograd.grad, K2 inside it)."""
from benchlib.spans import backward_ms as read  # noqa: F401
