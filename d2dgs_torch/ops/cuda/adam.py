"""Adam's update of a parameter group on the card, the wrapper of
``csrc/adam.cu``: one launch per ``MAX_LEAVES`` leaves of the group, the
leaf list in the kernel's parameter block, the bias corrections computed
on the card from the group's step count, and no read or copy by the host.

``train/optim.py`` ``adam_update`` sends every leaf of a group on the card
here and refuses one that ``leaf_fits`` does not pass (another dtype, a
strided parameter or moment); CPU tensors take its plain version, which
is also the kernel's oracle.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

SOURCE = "adam.cu"
# leaves a launch: csrc/adam.cu's MAX_LEAVES, checked when the library binds
MAX_LEAVES = 64


class Leaf(NamedTuple):
    p: torch.Tensor               # the parameter, updated in place
    g: torch.Tensor | None        # its gradient; None counts as zero
    m: torch.Tensor               # first moment, updated in place
    v: torch.Tensor               # second moment, updated in place
    lr: float


class _Leaves(ctypes.Structure):
    """csrc/adam.cu's ``AdamLeaves``: the leaf list of one launch."""
    _fields_ = [("p", ctypes.c_void_p * MAX_LEAVES),
                ("g", ctypes.c_void_p * MAX_LEAVES),
                ("m", ctypes.c_void_p * MAX_LEAVES),
                ("v", ctypes.c_void_p * MAX_LEAVES),
                ("numel", ctypes.c_longlong * MAX_LEAVES),
                ("tile_end", ctypes.c_int * MAX_LEAVES),
                ("lr", ctypes.c_float * MAX_LEAVES),
                ("n", ctypes.c_int)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.adam_max_leaves.restype = ctypes.c_int
    lib.adam_leaves_bytes.restype = ctypes.c_int
    if (lib.adam_max_leaves(), lib.adam_leaves_bytes()) != (
            MAX_LEAVES, ctypes.sizeof(_Leaves)):
        raise RuntimeError("csrc/adam.cu's leaf list does not match _Leaves")
    lib.adam_launch.argtypes = [ctypes.POINTER(_Leaves), ctypes.c_void_p] \
        + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    lib.adam_launch.restype = ctypes.c_int
    lib.adam_corrections_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.adam_corrections_launch.restype = ctypes.c_int
    lib.adam_error_string.argtypes = [ctypes.c_int]
    lib.adam_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + _lib().adam_error_string(err).decode())


def leaf_fits(leaf: Leaf, count: torch.Tensor) -> bool:
    """Whether the kernel takes the leaf at the int32 ``count`` (checked
    on any device, so the CPU tests hold the trainer's leaves to it): p, m and v float32, contiguous, of one shape and
    on the count's device; g None, or float32 of that shape on that device
    in any layout (``adam_step`` copies a strided one first: autograd
    returns slices of one concatenated gradient for the SH features); the
    learning rate a Python number."""
    dev, shape = count.device, leaf.p.shape
    if count.dtype != torch.int32 or not isinstance(leaf.lr, (int, float)):
        return False
    g = leaf.g
    return all(t.device == dev and t.dtype == torch.float32
               and t.is_contiguous() and t.shape == shape
               for t in (leaf.p, leaf.m, leaf.v)) and (
        g is None or (g.device == dev and g.dtype == torch.float32
                      and g.shape == shape))


def pack(leaves: list[Leaf]) -> list[_Leaves]:
    """The leaf lists of the launches: ``MAX_LEAVES`` leaves each, in
    order; a missing gradient is a null pointer.  ``tile_end`` is left to
    the launcher."""
    lists = []
    for s in range(0, len(leaves), MAX_LEAVES):
        part = leaves[s:s + MAX_LEAVES]
        lst = _Leaves()
        lst.n = len(part)
        for i, (p, g, m, v, lr) in enumerate(part):
            lst.p[i] = p.data_ptr()
            lst.g[i] = None if g is None else g.data_ptr()
            lst.m[i] = m.data_ptr()
            lst.v[i] = v.data_ptr()
            lst.numel[i] = p.numel()
            lst.lr[i] = lr
        lists.append(lst)
    return lists


def adam_step(leaves: list[Leaf], count: torch.Tensor, b1: float, b2: float,
              eps: float) -> None:
    """Updates every leaf in place at ``count``, the group's advanced step
    count (0-d int32 on the leaves' CUDA device); each leaf must satisfy
    ``leaf_fits``.  Nothing is read back or copied from the host; a
    strided gradient is copied to a contiguous one on the card."""
    if not leaves:
        return
    leaves = [lf if lf.g is None or lf.g.is_contiguous()
              else lf._replace(g=lf.g.contiguous()) for lf in leaves]
    dev = count.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lst in pack(leaves):
            _raise_on(_lib().adam_launch(
                ctypes.byref(lst), count.data_ptr(), b1, b2, 1 - b1, 1 - b2,
                eps, stream), "adam_launch")
            adam_step.launches += 1
    # the kernel writes through raw pointers: tell autograd, as an in-place
    # aten op would
    torch.autograd.graph.increment_version(
        [t for lf in leaves for t in (lf.p, lf.m, lf.v)])


adam_step.launches = 0


def adam_corrections(count: torch.Tensor, b1: float,
                     b2: float) -> torch.Tensor:
    """The kernel's bias corrections [1 - b1^t, 1 - b2^t] (float32 on the
    count's CUDA device) at the int32 count t in device memory."""
    out = torch.empty(2, dtype=torch.float32, device=count.device)
    with torch.cuda.device(count.device):
        stream = torch.cuda.current_stream(count.device).cuda_stream
        _raise_on(_lib().adam_corrections_launch(
            count.data_ptr(), b1, b2, out.data_ptr(), stream),
            "adam_corrections_launch")
    return out
