"""Build the port's CUDA sources into plain-C shared libraries.

Each source in ``d2dgs_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into ``.kernel_build/<hash>/`` at the repository root, where
the hash covers the source, the headers beside it (``*.cuh``) and the
compiler flags; a later call finds the library there and only loads it.
Libraries are bound with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / ".kernel_build"
# -fmad=false: no multiply-add contraction, so a kernel rounds each
# operation as its plain PyTorch version does (see csrc/blend_fwd.cu)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is built: a source that
    includes a header is built anew when the header changes."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / (Path(source).stem + ".so")


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library exists.  Returns the
    library path and the compiler's report (register and shared-memory
    use; empty when nothing was built).  Raises with the compiler output
    on failure."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)   # atomic under concurrent builds
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    lib, _ = build(source)
    return ctypes.CDLL(str(lib))
