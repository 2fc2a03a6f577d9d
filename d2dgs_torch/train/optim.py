"""Minimal functional Adam with one learning rate per parameter (counterpart
of d2dgs_tpu/train/optim.py).

torch.optim.Adam semantics as the reference uses it (gaussian_model.py:203,
eps=1e-15): bias-corrected moments, eps added *after* the sqrt, one step
count per group.  Parameters are a flat dict of name -> tensor and the
moments are dicts of the same names, so densification can permute or zero
moment rows with plain tensor ops.  Unlike the JAX package, the update
runs in place: parameters and moments are overwritten, and the returned
state holds the same moment tensors with the count advanced.

On the card, ``adam_update`` updates every leaf of a group in one launch
of ``csrc/adam.cu`` (``ops/cuda/adam.py``), bitwise as the plain version
does, with no host read or copy, and refuses a leaf the kernel cannot
take; CPU tensors take the plain version (``adam_update_plain``).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from .. import trace
from ..ops.cuda import adam as adam_cuda
from ..ops.cuda.adam import Leaf


class AdamState(NamedTuple):
    mu: dict      # first moments, name -> tensor like the parameter
    nu: dict      # second moments
    count: torch.Tensor   # 0-d int32 step count of the group


def adam_init(params: Mapping[str, torch.Tensor], device=None) -> AdamState:
    """Zero moments and count; ``device`` places the count of a group
    without parameters (the static deform field's)."""
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    dev = device if device is not None else next(iter(params.values())).device
    return AdamState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def _leaves(grads, state: AdamState, params, lr) -> list[Leaf]:
    return [Leaf(p, grads.get(k), state.mu[k], state.nu[k],
                 lr[k] if isinstance(lr, Mapping) else lr)
            for k, p in params.items()]


def _plain_leaves(leaves: list[Leaf], count: torch.Tensor, b1: float,
                  b2: float, eps: float) -> None:
    """The plain version: one chain of aten ops a leaf."""
    t = count.to(torch.float32)
    trace.count("host.reads", 2)  # two copies from host memory
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=t.device), t)
    for p, g, m, v, step_lr in leaves:
        if g is None:
            g = torch.zeros_like(p)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(step_lr * (m / c1) / (torch.sqrt(v / c2) + eps))


@torch.no_grad()
def adam_update_plain(grads: Mapping[str, torch.Tensor | None],
                      state: AdamState, params: Mapping[str, torch.Tensor],
                      lr, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-15) -> AdamState:
    """``adam_update`` through the plain version for every leaf: the CPU
    version and the kernel's oracle."""
    count = state.count + 1
    _plain_leaves(_leaves(grads, state, params, lr), count, b1, b2, eps)
    return AdamState(mu=state.mu, nu=state.nu, count=count)


@torch.no_grad()
def adam_update(grads: Mapping[str, torch.Tensor | None], state: AdamState,
                params: Mapping[str, torch.Tensor], lr,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> AdamState:
    """One Adam step of the group.  ``lr``: one float for the group or a
    dict of floats by name; a missing gradient (None) counts as zero.
    Updates ``params`` and the moments in place; returns the new state.
    On a CUDA count every leaf goes to the kernel, and a leaf it cannot
    take (``adam_cuda.leaf_fits``) raises ValueError before anything is
    written.  Under a profiler, counts ``adam.leaves`` and
    ``adam.kernel_leaves`` (those the kernel updated)."""
    count = state.count + 1
    leaves = _leaves(grads, state, params, lr)
    on_card = count.device.type == "cuda"
    if on_card:
        for k, lf in zip(params, leaves):
            if not adam_cuda.leaf_fits(lf, count):
                raise ValueError(
                    f"Adam's kernel cannot take leaf {k!r}: it needs p, m "
                    "and v float32, contiguous, of one shape on the count's "
                    "device, the gradient None or float32 of that shape, "
                    "and a Python number as learning rate")
        adam_cuda.adam_step(leaves, count, b1, b2, eps)
    else:
        _plain_leaves(leaves, count, b1, b2, eps)
    trace.count("adam.leaves", len(leaves))
    trace.count("adam.kernel_leaves", len(leaves) if on_card else 0)
    return AdamState(mu=state.mu, nu=state.nu, count=count)
