"""Small general-purpose helpers (counterpart of d2dgs_tpu/utils/general.py)."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: ``cuda`` unless the caller
    asks for another.  Raises when CUDA is asked for and absent, so no
    entry point quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev


def inverse_sigmoid(x):
    """logit; a Python float is divided in float64 and logged in float32,
    as the JAX package does with a weak-typed scalar."""
    return torch.log(torch.as_tensor(x / (1.0 - x)))


def farthest_point_sample(points: torch.Tensor, n_sample: int,
                          generator: torch.Generator | None = None,
                          start: int | None = None) -> torch.Tensor:
    """FPS over [N, D] points -> [n_sample] int32 indices (time_utils.py
    farthest_point_sample): greedy max-min sampling from a start point
    that is either given or drawn from ``generator``."""
    n = points.shape[0]
    if start is None:
        start = int(torch.randint(0, n, (1,), generator=generator).item())
    idxs = torch.empty((n_sample,), dtype=torch.int64, device=points.device)
    idxs[0] = start
    dist = torch.full((n,), float("inf"), dtype=points.dtype,
                      device=points.device)
    for i in range(1, n_sample):
        d = torch.sum((points - points[idxs[i - 1]]) ** 2, dim=-1)
        dist = torch.minimum(dist, d)
        idxs[i] = torch.argmax(dist)
    return idxs.to(torch.int32)
