"""Offline data-preparation tools (counterparts of d2dgs_tpu/tools/: the
reference's convert.py, data_tools/colmap2nerf.py and
data_tools/phone_catch.py), host-only copies in numpy and PIL.

They drive external binaries (colmap, ffmpeg) through subprocess and fail
with actionable errors when a binary is missing; nothing here touches
the GPU.
"""
