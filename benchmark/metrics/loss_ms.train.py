"""The losses' stream time per training step (ms): the d2dgs.loss
spans' (L1, D-SSIM, normal and distortion terms; the ARAP term)."""
from benchlib.spans import loss_ms as read  # noqa: F401
