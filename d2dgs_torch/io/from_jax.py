"""Carry weights across from the JAX package's checkpoints.

The JAX package saves its whole TrainState with ``np.savez`` (format 2,
d2dgs_tpu/io/checkpoint.py): one array per leaf, keyed
``"leaf:" + keystr(path)``, e.g. ``leaf:.gauss.xyz`` or
``leaf:.nodes.mlp['layers'][0]['w']``.  This module reads those arrays
with numpy alone and builds the port's Gaussian and node state from the
``.gauss`` and ``.nodes`` leaves.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ..models.deform_mlp import mlp_from_arrays
from ..models.gaussians import GaussianParams
from ..models.nodes import NodeParams
from ..utils.general import resolve_device

FORMAT = 2
_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _parse_path(key: str) -> list:
    """keystr path -> components: '.nodes.mlp['layers'][0]['w']' ->
    ['nodes', 'mlp', 'layers', 0, 'w']."""
    out, pos = [], 0
    for m in _TOKEN.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unparsable tree path {key!r}")
        attr, name, index = m.groups()
        out.append(int(index) if index is not None else (attr or name))
        pos = m.end()
    if pos != len(key):
        raise ValueError(f"unparsable tree path {key!r}")
    return out


def _nest(items) -> dict:
    """[(path components, array)] -> nested dicts; integer components
    become lists."""
    root: dict = {}
    for path, arr in items:
        d = root
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = arr

    def listify(d):
        if not isinstance(d, dict):
            return d
        if d and all(isinstance(k, int) for k in d):
            return [listify(d[i]) for i in range(len(d))]
        return {k: listify(v) for k, v in d.items()}

    return listify(root)


def from_jax_arrays(leaves: Mapping[str, np.ndarray], device="cuda",
                    with_motion_mask: bool = True):
    """Build (GaussianParams, NodeParams) from JAX TrainState leaves keyed
    by their keystr path (with or without the ``leaf:`` prefix).
    ``with_motion_mask`` is static metadata the arrays do not carry (the
    JAX trainer's Gaussians always have it)."""
    dev = resolve_device(device)
    items = []
    for key, arr in leaves.items():
        key = key[len("leaf:"):] if key.startswith("leaf:") else key
        path = _parse_path(key)
        if path[0] in ("gauss", "nodes"):
            items.append((path, np.asarray(arr)))
    tree = _nest(items)
    for part in ("gauss", "nodes"):
        if part not in tree:
            raise KeyError(f"no '.{part}' leaves among {sorted(leaves)[:8]}")
    g, n = tree["gauss"], tree["nodes"]
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    gauss = GaussianParams(
        xyz=t(g["xyz"]), features_dc=t(g["features_dc"]),
        features_rest=t(g["features_rest"]), scaling=t(g["scaling"]),
        rotation=t(g["rotation"]), opacity=t(g["opacity"]),
        feature=t(g["feature"]), alive=t(g["alive"]).to(torch.bool),
        active_sh_degree=int(g["active_sh_degree"]),
        with_motion_mask=with_motion_mask)
    nodes = NodeParams(
        nodes=t(n["nodes"]), node_radius=t(n["node_radius"]),
        node_weight=t(n["node_weight"]), mlp=mlp_from_arrays(n["mlp"], dev),
        alive=t(n["alive"]).to(torch.bool))
    return gauss, nodes


def load_jax_checkpoint(path: str, device="cuda",
                        with_motion_mask: bool = True):
    """Read a format-2 JAX checkpoint -> (GaussianParams, NodeParams)."""
    with np.load(path) as z:
        fmt = int(z["__format__"]) if "__format__" in z.files else 1
        if fmt != FORMAT:
            raise ValueError(f"checkpoint {path} is format {fmt}; only "
                             f"format {FORMAT} (tree-path keys) is read")
        leaves = {k: z[k] for k in z.files if k.startswith("leaf:")}
    return from_jax_arrays(leaves, device=device,
                           with_motion_mask=with_motion_mask)
