"""The deformation fields, one module each, found by the configuration's
``deform_type``: ``fields/<deform_type>.py``.  A module gives

- ``shapes(cfg)``: (name, shape, init, scale) of the field's leaves,
  named as the port names them: init "u" uniform in +-scale, "n" normal
  of std scale, "0" zeros;
- ``extra_state(cfg, gauss, n, seeds, device)``: what the field holds
  besides its weights (the node field's control nodes), or None;
- ``forward(state, cfg, t, step)``: the plain reference's (d_xyz,
  d_rotation, d_scaling) of every slot at time ``t``;
- ``fwd_ops(cfg, n_live)``: the forward's operations for ``n_live``
  surfels, (those that are differentiated, those that are not).

A field is added by adding its module and a configuration naming it.
"""
from __future__ import annotations

import importlib


def field(deform_type: str):
    name = f"{__name__}.{deform_type}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no field for deform_type {deform_type!r}") from e


def dense_ops(rows: int, dims: list) -> float:
    """Operations of a chain of dense layers over ``rows`` rows:
    2 * fan_in * fan_out each."""
    return 2.0 * rows * sum(a * b for a, b in dims)
