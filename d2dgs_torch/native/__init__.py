"""The port's ctypes binding of the C++ mesh post-processing library
(counterpart of d2dgs_tpu/native/__init__.py).

``native/mesh_post.cpp`` (the weld, connected-components and cluster-
filter loops that the reference runs inside Open3D, utils/mesh_utils.py:
24-45) is compiled by ``g++`` into ``.kernel_build/<hash>/`` at the
repository root, where the hash covers the source and the flags, and is
loaded with ctypes; ``native/`` itself is only read.  Without a C++
toolchain every entry point warns once and runs its numpy version (the
``*_np`` functions, also the plain versions the tests hold the library
against); ``available()`` says which runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mesh_post.cpp"
BUILD_ROOT = ROOT / ".kernel_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_LIB = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libd2dgs_native.so"


def build() -> Path:
    """Compile the library unless it exists; raises on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic under concurrent builds
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        warnings.warn(f"d2dgs_torch native library unavailable ({e}); "
                      "using the numpy versions")
        return None
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.d2dgs_weld_mesh.restype = i64
    lib.d2dgs_weld_mesh.argtypes = [pf, i64, f64, pf, pi, pi64]
    lib.d2dgs_connected_components.restype = i32
    lib.d2dgs_connected_components.argtypes = [pi, i64, i32, pi]
    lib.d2dgs_filter_components.restype = i64
    lib.d2dgs_filter_components.argtypes = [
        pf, i32, pi, i64, i32, f64, pf, pi, pi64, pu8, pi]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def weld_mesh(tris: np.ndarray, cell: float):
    """Triangle soup [T,3,3] -> (verts [V,3], faces [F,3]).  Vertices in
    one `cell` merge (position: the mean of the members), numbered in
    order of first appearance; degenerate faces are dropped."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 3)
    n_tris = tris.shape[0]
    if n_tris == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    lib = _load()
    if lib is None:
        return weld_mesh_np(tris, cell)
    out_verts = np.empty((n_tris * 3, 3), np.float32)
    out_faces = np.empty((n_tris, 3), np.int32)
    n_faces = np.zeros(1, np.int64)
    n_verts = lib.d2dgs_weld_mesh(tris.reshape(-1), n_tris, cell,
                                  out_verts.reshape(-1),
                                  out_faces.reshape(-1), n_faces)
    return out_verts[:n_verts].copy(), out_faces[:int(n_faces[0])].copy()


def filter_components(verts: np.ndarray, faces: np.ndarray, keep: int = 1,
                      min_ratio: float = 0.0):
    """Keep the `keep` largest edge-connected components (by face count),
    plus any with >= min_ratio * the largest's faces.  Returns compacted
    (verts, faces)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if faces.shape[0] == 0:
        return verts, faces
    lib = _load()
    if lib is None:
        return filter_components_np(verts, faces, keep, min_ratio)
    out_verts = np.empty_like(verts)
    out_faces = np.empty_like(faces)
    n_faces = np.zeros(1, np.int64)
    mask = np.empty(faces.shape[0], np.uint8)
    new_index = np.empty(verts.shape[0], np.int32)
    n_verts = lib.d2dgs_filter_components(
        verts.reshape(-1), verts.shape[0], faces.reshape(-1),
        faces.shape[0], keep, min_ratio, out_verts.reshape(-1),
        out_faces.reshape(-1), n_faces, mask, new_index)
    return out_verts[:n_verts].copy(), out_faces[:int(n_faces[0])].copy()


def connected_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Per-vertex component labels (0..k-1, in order of first vertex)."""
    faces = np.ascontiguousarray(faces, np.int32)
    lib = _load()
    if lib is None:
        return connected_components_np(faces, n_verts)
    labels = np.empty(n_verts, np.int32)
    lib.d2dgs_connected_components(faces.reshape(-1), faces.shape[0],
                                   n_verts, labels)
    return labels


# ------------------------------------------------------- numpy versions

def weld_mesh_np(tris, cell):
    """The weld in numpy: the same welded mesh, vertices numbered in
    order of their quantized keys."""
    flat = np.asarray(tris, np.float32).reshape(-1, 3)
    keys = np.round(flat / cell).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=uniq.shape[0])[:, None]
    verts = (verts / counts).astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def connected_components_np(faces, n_verts):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as cc
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [0, 2]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                        shape=(n_verts, n_verts))
    _, label = cc(adj, directed=False)
    return label.astype(np.int32)


def filter_components_np(verts, faces, keep, min_ratio):
    label = connected_components_np(faces, verts.shape[0])
    fl = label[faces[:, 0]]
    sizes = np.bincount(fl)
    order = np.argsort(sizes)[::-1]
    chosen = set(order[:keep].tolist())
    if min_ratio > 0:
        chosen |= set(np.where(sizes >= min_ratio * sizes.max())[0].tolist())
    mask = np.isin(fl, list(chosen))
    faces2 = faces[mask]
    used = np.unique(faces2)
    remap = -np.ones(verts.shape[0], np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces2].astype(np.int32)
