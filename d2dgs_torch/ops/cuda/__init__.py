"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper builds its kernel at first use from ``d2dgs_torch/csrc``
with ``nvcc`` (see ``build.py``), launches it on CUDA tensors, uses the
plain PyTorch version on CPU tensors, and counts its launches.
"""
