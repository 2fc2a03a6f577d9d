"""PyTorch/CUDA port of the D-2DGS framework in ``d2dgs_tpu``.

Module paths mirror ``d2dgs_tpu`` so each counterpart is easy to find.
The port imports torch and numpy only.  Entry points (state builders,
the checkpoint loader, cameras) put tensors on ``cuda`` unless the
caller passes ``device="cpu"``; they raise when CUDA is asked for and
absent.  Functions that take tensors run on the tensors' device: a CUDA
tensor goes through the hand-written kernels (``ops/cuda``), a CPU
tensor through their plain PyTorch versions.
"""
