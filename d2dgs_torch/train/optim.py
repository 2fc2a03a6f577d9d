"""Minimal functional Adam with one learning rate per parameter (counterpart
of d2dgs_tpu/train/optim.py).

torch.optim.Adam semantics as the reference uses it (gaussian_model.py:203,
eps=1e-15): bias-corrected moments, eps added *after* the sqrt, one step
count per group.  Parameters are a flat dict of name -> tensor and the
moments are dicts of the same names, so densification can permute or zero
moment rows with plain tensor ops.  Unlike the JAX package, the update
runs in place: parameters and moments are overwritten, and the returned
state holds the same moment tensors with the count advanced.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: dict      # first moments, name -> tensor like the parameter
    nu: dict      # second moments
    count: torch.Tensor   # 0-d int32 step count of the group


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update(grads: Mapping[str, torch.Tensor | None], state: AdamState,
                params: Mapping[str, torch.Tensor], lr,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> AdamState:
    """One Adam step of the group.  ``lr``: one float for the group or a
    dict of floats by name; a missing gradient (None) counts as zero.
    Updates ``params`` and the moments in place; returns the new state."""
    count = state.count + 1
    t = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=t.device), t)
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            g = torch.zeros_like(p)
        m, v = state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        step_lr = lr[k] if isinstance(lr, Mapping) else lr
        p.sub_(step_lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return AdamState(mu=state.mu, nu=state.nu, count=count)
