"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper builds its kernel at first use from ``d2dgs_torch/csrc``
with ``nvcc``, launches it on CUDA tensors, uses the plain PyTorch
version on CPU tensors, and counts its launches.  ``build.py`` holds what
they share: the build, ``Library`` (one per source: its entry points'
arguments, bound once, and the launch with its error check) and
``expect`` (the check of a tensor argument).
"""
