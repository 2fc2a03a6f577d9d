"""Build the port's CUDA sources into plain-C shared libraries.

Each source in ``d2dgs_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into ``.kernel_build/<hash>/`` at the repository root, where
the hash covers the source, the headers beside it (``*.cuh``) and the
compiler flags; a later call finds the library there and only loads it.
``Library`` binds a library's entry points with ctypes and launches
them; ``expect`` is the launchers' check of a tensor argument.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


# the letters of an entry point's arguments in ``Library``'s table
ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
             "f": ctypes.c_float}
# what ``Library.call`` passes as it is; anything else is a tensor
_AS_IS = frozenset((int, float, type(None)))


def expect(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: int | tuple, device: torch.device) -> None:
    """Raises unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    with ``shape`` dims (an int) or of ``shape`` (a tuple; None matches
    any length): TypeError on the dtype, ValueError on the device, the
    rank, contiguity or the shape, each naming ``name``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    sized = type(shape) is not int
    if not (sized and t.shape == shape):     # an exact shape passes at once
        ndim = len(shape) if sized else shape
        if t.dim() != ndim:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{ndim} dims")
        if sized and any(want is not None and want != got
                         for want, got in zip(shape, t.shape)):
            wanted = ", ".join("n" if s is None else str(s) for s in shape)
            raise ValueError(f"{name} must be [{wanted}], got "
                             f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class Library:
    """The library of ``csrc/<source>``, built, loaded and bound at its
    first use.  ``entries`` maps each entry point to its C arguments in
    order, one letter of ``ARG_TYPES`` each (spaces are ignored); every
    entry point returns an int, zero or an error code that the library's
    ``<stem>_error_string`` export explains.  ``check`` (optional) is
    called with the loaded library, to hold a layout the C side defines
    to the Python one."""

    def __init__(self, source: str, entries: dict[str, str], check=None):
        self.source, self.entries, self.check = source, entries, check
        self._lib, self._error = None, Path(source).stem + "_error_string"

    def bind(self) -> ctypes.CDLL:
        """The loaded library, every entry point declared; builds it at
        the first call."""
        if self._lib is None:
            lib = load(self.source)
            for name, args in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = [ARG_TYPES[c] for c in args.replace(" ", "")]
                fn.restype = ctypes.c_int
            error = getattr(lib, self._error)
            error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
            if self.check is not None:
                self.check(lib)
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        """Calls the entry point ``name``: a tensor as its data pointer,
        None as a null pointer, an int (a raw address among them) or a
        float as it is; raises RuntimeError with the library's message on
        a non-zero return."""
        lib = self._lib or self.bind()
        err = getattr(lib, name)(*[a if type(a) in _AS_IS else a.data_ptr()
                                   for a in args])
        if err:
            message = getattr(lib, self._error)(err).decode()
            raise RuntimeError(f"{name} failed: {message}")

    def launch(self, name: str, device: torch.device, *args) -> None:
        """``call`` with the CUDA ``device`` current and its current
        stream as the last argument."""
        with torch.cuda.device(device):
            self.call(name, *args,
                      torch.cuda.current_stream(device).cuda_stream)
