"""Whole-TrainState checkpoints (counterpart of d2dgs_tpu/io/checkpoint.py),
in the JAX package's format 2, so either package loads the other's.

One ``np.savez`` array per leaf of the JAX ``TrainState``, keyed
``"leaf:" + keystr(path)`` (``leaf:.gauss.xyz``,
``leaf:.mlp_opt.mu['layers'][0]['w']``, ...), plus ``__format__``,
``__iteration__`` and ``__iteration_node__``.  The port builds those
keys from a fixed table of the TrainState's fields.  The JAX PRNG key
``.key`` (uint32[2]) holds the low and high words of the port's
generator seed; the generator's whole state goes along as
``__torch_generator__``, which the JAX loader ignores.  A JAX checkpoint
has no generator state: the port seeds its generator from ``.key``, as
``io/from_jax.py`` does.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.densify import DensifyStats
from ..train.trainer import GAUSS_FIELDS, NODE_FIELDS, TrainState

FORMAT = 2
GENERATOR = "__torch_generator__"


def _name_key(name: str) -> str:
    """A parameter name as a keystr suffix: "layers.0.w" ->
    "['layers'][0]['w']"."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def tensor_leaves(state: TrainState) -> dict:
    """keystr path -> tensor for every tensor leaf of the JAX TrainState
    that ``state`` holds (the stage-1 parts only when present).  The two
    leaves that are not tensors in the port, ``.{gauss,ngauss}.
    active_sh_degree`` and ``.key``, are the callers' to handle."""
    out = {}

    def gauss(prefix, g):
        for f in GAUSS_FIELDS + ("alive",):
            out[f"{prefix}.{f}"] = getattr(g, f)

    def adam(prefix, opt):
        for part in ("mu", "nu"):
            for name, t in getattr(opt, part).items():
                out[f"{prefix}.{part}{_name_key(name)}"] = t
        out[f"{prefix}.count"] = opt.count

    def stats(prefix, s):
        for f in DensifyStats._fields:
            out[f"{prefix}.{f}"] = getattr(s, f)

    gauss(".gauss", state.gauss)
    adam(".gauss_opt", state.gauss_opt)
    stats(".gauss_stats", state.gauss_stats)
    for f in NODE_FIELDS:
        out[f".nodes.{f}"] = getattr(state.nodes, f)
    for name, t in state.nodes.mlp.named_parameters():
        out[f".nodes.mlp{_name_key(name)}"] = t
    out[".nodes.alive"] = state.nodes.alive
    adam(".node_opt", state.node_opt)
    adam(".mlp_opt", state.mlp_opt)
    if state.ngauss is not None:
        gauss(".ngauss", state.ngauss)
        adam(".ngauss_opt", state.ngauss_opt)
        stats(".ngauss_stats", state.ngauss_stats)
    return out


def _gaussian_parts(state: TrainState):
    return [(p, g) for p, g in (("gauss", state.gauss),
                                ("ngauss", state.ngauss)) if g is not None]


def save_train_state(path: str, state: TrainState, iteration: int = 0,
                     iteration_node: int = 0) -> None:
    arrays = {"leaf:" + k: t.detach().cpu().numpy()
              for k, t in tensor_leaves(state).items()}
    for part, g in _gaussian_parts(state):
        arrays[f"leaf:.{part}.active_sh_degree"] = np.asarray(
            g.active_sh_degree, np.int32)
    seed = state.generator.initial_seed()
    arrays["leaf:.key"] = np.asarray([seed & 0xFFFFFFFF, seed >> 32],
                                     np.uint32)
    arrays[GENERATOR] = state.generator.get_state().numpy()
    arrays["__format__"] = np.asarray(FORMAT)
    arrays["__iteration__"] = np.asarray(iteration)
    arrays["__iteration_node__"] = np.asarray(iteration_node)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


@torch.no_grad()
def load_train_state(path: str, template: TrainState):
    """Load into ``template`` (a TrainState of the same configuration, e.g.
    from ``init_train_state``), in place.  Returns (state, iteration,
    iteration_node)."""
    with np.load(path) as z:
        fmt = int(z["__format__"]) if "__format__" in z.files else 1
        if fmt != FORMAT:
            raise ValueError(f"checkpoint {path} is format {fmt}; only "
                             f"format {FORMAT} (tree-path keys) is read")

        def read(key, shape):
            k = "leaf:" + key
            if k not in z.files:
                raise KeyError(
                    f"checkpoint {path} has no array for tree path {key!r} "
                    f"(saved from a different TrainState layout?)")
            a = z[k]
            if a.shape != tuple(shape):
                raise ValueError(f"tree path {key!r}: checkpoint shape "
                                 f"{a.shape} vs template {tuple(shape)} "
                                 f"(config mismatch?)")
            return a

        for key, t in tensor_leaves(template).items():
            t.copy_(torch.from_numpy(np.array(read(key, t.shape))))
        for part, g in _gaussian_parts(template):
            g.active_sh_degree = int(read(f".{part}.active_sh_degree", ()))
        key = read(".key", (2,))
        if GENERATOR in z.files:
            template.generator.set_state(torch.from_numpy(z[GENERATOR]))
        else:
            template.generator.manual_seed(int.from_bytes(
                key.astype("<u4").tobytes(), "little") % (1 << 63))
        it = int(z["__iteration__"])
        it_node = int(z["__iteration_node__"])
    return template, it, it_node
