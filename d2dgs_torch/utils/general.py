"""Small general-purpose helpers (counterpart of d2dgs_tpu/utils/general.py)."""
from __future__ import annotations

import math

import numpy as np
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


def get_expon_lr_func(lr_init: float, lr_final: float,
                      lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
                      max_steps: int = 1_000_000):
    """Log-linear LR interpolation with optional delayed warm-up
    (general_utils.py get_expon_lr_func).  Returns step -> float, computed
    in float32 as the JAX package does; 0 for step < 0 or a non-positive
    end point."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def helper(step) -> float:
        step = f32(float(step))
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(f32(math.log(lr_init)) * (1 - t)
                             + f32(math.log(lr_final)) * t) \
            if lr_init > 0 and lr_final > 0 else f32(0.0)
        if float(step) < 0:
            return 0.0
        return float(delay_rate * log_lerp)
    return helper


def get_linear_noise_func(lr_init: float, lr_final: float,
                          lr_delay_steps: int = 0,
                          lr_delay_mult: float = 1.0,
                          max_steps: int = 1_000_000):
    """Linear (not log) interpolation with the same delayed warm-up shape:
    the reference's time-noise magnitude schedule (general_utils.py
    get_linear_noise_func, used at train_gui.py:189).  Returns step ->
    float, in float64 on the host as the JAX package does."""
    def helper(step) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        return float(delay_rate * (lr_init * (1 - t) + lr_final * t))
    return helper


def farthest_point_sample(points: torch.Tensor, n_sample: int,
                          generator: torch.Generator | None = None,
                          start: int | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """FPS over [N, D] points -> [n_sample] int32 indices (time_utils.py
    farthest_point_sample): greedy max-min sampling from a start point
    that is either given or drawn from ``generator``.  ``mask`` (optional
    [N] bool): points outside it are never selected, and a drawn start is
    one of the points inside it."""
    n = points.shape[0]
    if start is None:
        if mask is None:
            start = int(torch.randint(0, n, (1,), generator=generator))
        else:
            inside = torch.nonzero(mask.cpu()).flatten()
            start = int(inside[torch.randint(0, inside.numel(), (1,),
                                             generator=generator)])
    idxs = torch.empty((n_sample,), dtype=torch.int64, device=points.device)
    idxs[0] = start
    dist = torch.full((n,), float("inf"), dtype=points.dtype,
                      device=points.device)
    for i in range(1, n_sample):
        d = torch.sum((points - points[idxs[i - 1]]) ** 2, dim=-1)
        dist = torch.minimum(dist, d)
        pick = dist if mask is None else torch.where(mask, dist, -1.0)
        idxs[i] = torch.argmax(pick)
    return idxs.to(torch.int32)


def strip_lowerdiag_sym(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> packed [..., 6] (uplo upper triangle)."""
    return torch.stack([m[..., 0, 0], m[..., 0, 1], m[..., 0, 2],
                        m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]], dim=-1)
