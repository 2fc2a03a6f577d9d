"""Carry weights and training state across from the JAX package.

The JAX package saves its whole TrainState with ``np.savez`` (format 2,
d2dgs_tpu/io/checkpoint.py): one array per leaf, keyed
``"leaf:" + keystr(path)``, e.g. ``leaf:.gauss.xyz`` or
``leaf:.nodes.mlp['layers'][0]['w']``.  This module reads those arrays
with numpy alone.  ``from_jax_arrays`` builds the port's Gaussian and
node state from the ``.gauss`` and ``.nodes`` leaves;
``train_state_from_jax_arrays`` builds a whole ``TrainState``: also the
Adam moments and counts (``.gauss_opt``, ``.node_opt``, ``.mlp_opt``),
the densify statistics (``.gauss_stats``) and, where present, the
stage-1 node Gaussians (``.ngauss``, ``.ngauss_opt``, ``.ngauss_stats``),
so a step can start from the same state in both packages.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ..models.deform_mlp import mlp_from_arrays
from ..models.densify import DensifyStats
from ..models.gaussians import GaussianParams
from ..models.nodes import NodeParams
from ..train.optim import AdamState
from ..train.trainer import TrainState
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


def _flat_names(tree, prefix="") -> dict:
    """Nested dicts/lists -> {"layers.0.w": array, ...}, the names of
    ``nn.Module.named_parameters``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_names(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _tree(leaves: Mapping[str, np.ndarray], parts) -> dict:
    items = []
    for key, arr in leaves.items():
        key = key[len("leaf:"):] if key.startswith("leaf:") else key
        path = _parse_path(key)
        if path[0] in parts:
            items.append((path, np.asarray(arr)))
    return _nest(items)


def _gauss(g: dict, t, with_motion_mask: bool,
           isotropic: bool = False) -> GaussianParams:
    return GaussianParams(
        xyz=t(g["xyz"]), features_dc=t(g["features_dc"]),
        features_rest=t(g["features_rest"]), scaling=t(g["scaling"]),
        rotation=t(g["rotation"]), opacity=t(g["opacity"]),
        feature=t(g["feature"]), alive=t(g["alive"]).to(torch.bool),
        active_sh_degree=int(g["active_sh_degree"]),
        with_motion_mask=with_motion_mask, isotropic_shared_scale=isotropic)


def _adam(o: dict, t) -> AdamState:
    """A group's moments; a group without parameters (the static field's)
    has no mu/nu leaves."""
    return AdamState(
        mu={k: t(v) for k, v in _flat_names(o.get("mu", {})).items()},
        nu={k: t(v) for k, v in _flat_names(o.get("nu", {})).items()},
        count=t(o["count"]).to(torch.int32))


def _stats(s: dict, t) -> DensifyStats:
    return DensifyStats(*(t(s[f]) for f in DensifyStats._fields))


def from_jax_arrays(leaves: Mapping[str, np.ndarray], device="cuda",
                    with_motion_mask: bool = True):
    """Build (GaussianParams, NodeParams) from JAX TrainState leaves keyed
    by their keystr path (with or without the ``leaf:`` prefix).  The
    node slot's ``mlp`` holds whichever deform field the state was
    trained with: the node MLP, the mlp or hash field, or nothing
    (static).
    ``with_motion_mask`` is static metadata the arrays do not carry (the
    JAX trainer's Gaussians always have it)."""
    dev = resolve_device(device)
    tree = _tree(leaves, ("gauss", "nodes"))
    for part in ("gauss", "nodes"):
        if part not in tree:
            raise KeyError(f"no '.{part}' leaves among {sorted(leaves)[:8]}")
    n = tree["nodes"]
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    gauss = _gauss(tree["gauss"], t, with_motion_mask)
    nodes = NodeParams(
        nodes=t(n["nodes"]), node_radius=t(n["node_radius"]),
        node_weight=t(n["node_weight"]),
        mlp=mlp_from_arrays(n.get("mlp", {}), dev),
        alive=t(n["alive"]).to(torch.bool))
    return gauss, nodes


def train_state_from_jax_arrays(leaves: Mapping[str, np.ndarray],
                                device="cuda", with_motion_mask: bool = True
                                ) -> TrainState:
    """Build a whole TrainState from JAX TrainState leaves (see
    ``from_jax_arrays``).  The stage-1 node Gaussians are isotropic, as
    the JAX trainer builds them, and carry a motion mask when they have a
    feature channel.  The port's generator for the later random draws is
    seeded from the JAX key's words (the two packages' streams differ
    anyway)."""
    dev = resolve_device(device)
    gauss, nodes = from_jax_arrays(leaves, device=dev,
                                   with_motion_mask=with_motion_mask)
    tree = _tree(leaves, ("gauss_opt", "gauss_stats", "node_opt", "mlp_opt",
                          "ngauss", "ngauss_opt", "ngauss_stats", "key"))
    for part in ("gauss_opt", "gauss_stats", "node_opt", "mlp_opt"):
        if part not in tree:
            raise KeyError(f"no '.{part}' leaves among {sorted(leaves)[:8]}")
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    key = np.asarray(tree.get("key", 0), np.uint32).tobytes()
    generator = torch.Generator().manual_seed(
        int.from_bytes(key, "little") % (1 << 63))
    ngauss = ngauss_opt = ngauss_stats = None
    if "ngauss" in tree:
        ng = tree["ngauss"]
        ngauss = _gauss(ng, t, with_motion_mask=ng["feature"].shape[-1] > 0,
                        isotropic=True)
        ngauss_opt = _adam(tree["ngauss_opt"], t)
        ngauss_stats = _stats(tree["ngauss_stats"], t)
    return TrainState(
        gauss=gauss, gauss_opt=_adam(tree["gauss_opt"], t),
        gauss_stats=_stats(tree["gauss_stats"], t), nodes=nodes,
        node_opt=_adam(tree["node_opt"], t),
        mlp_opt=_adam(tree["mlp_opt"], t), generator=generator,
        ngauss=ngauss, ngauss_opt=ngauss_opt, ngauss_stats=ngauss_stats)


def _read_leaves(path: str) -> dict:
    with np.load(path) as z:
        fmt = int(z["__format__"]) if "__format__" in z.files else 1
        if fmt != FORMAT:
            raise ValueError(f"checkpoint {path} is format {fmt}; only "
                             f"format {FORMAT} (tree-path keys) is read")
        return {k: z[k] for k in z.files if k.startswith("leaf:")}


def load_jax_checkpoint(path: str, device="cuda",
                        with_motion_mask: bool = True):
    """Read a format-2 JAX checkpoint -> (GaussianParams, NodeParams)."""
    return from_jax_arrays(_read_leaves(path), device=device,
                           with_motion_mask=with_motion_mask)


def load_jax_train_state(path: str, device="cuda",
                         with_motion_mask: bool = True) -> TrainState:
    """Read a format-2 JAX checkpoint -> TrainState."""
    return train_state_from_jax_arrays(
        _read_leaves(path), device=device, with_motion_mask=with_motion_mask)
