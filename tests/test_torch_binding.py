"""The binding of the port's CUDA libraries (d2dgs_torch/ops/cuda/build.py)
on the CPU: ``expect``'s refusals, ``Library``'s declarations and calls
through a stand-in for the loaded library, and every launcher's table of
entry points against the C declarations in d2dgs_torch/csrc."""
import ctypes
import re

import pytest
import torch

from d2dgs_torch.ops.cuda import adam, blend, build, node_gather, raster3d

torch.set_num_threads(1)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")       # compared against, never allocated on
LIBRARIES = {lib.source: lib for lib in (
    blend.LIB_FWD, blend.LIB_BWD, raster3d.LIB, node_gather.LIB, adam.LIB)}


def test_expect_passes_a_fitting_tensor():
    t = torch.zeros(3, 4, dtype=torch.int32)
    for shape in (2, (3, 4), (None, 4), (None, None)):
        build.expect("t", t, torch.int32, shape, CPU)


REFUSALS = {
    # name: (tensor, dtype, shape, device, exception, message)
    "device": (torch.zeros(3, 4), torch.float32, 2, CUDA, ValueError,
               r"^t is on cpu, expected cuda$"),
    "device-before-dtype": (torch.zeros(3, 4, dtype=torch.float64),
                            torch.float32, 2, CUDA, ValueError,
                            "expected cuda"),
    "dtype": (torch.zeros(3, 4, dtype=torch.float64), torch.float32, 2, CPU,
              TypeError, r"^t has dtype torch.float64, expected torch.float32$"),
    "rank": (torch.zeros(3, 4), torch.float32, 3, CPU, ValueError,
             r"^t has shape \(3, 4\), expected 3 dims$"),
    "rank-of-shape": (torch.zeros(3, 4), torch.float32, (3, 4, 1), CPU,
                      ValueError, r"^t has shape \(3, 4\), expected 3 dims$"),
    "shape": (torch.zeros(3, 4), torch.float32, (3, 5), CPU, ValueError,
              r"^t must be \[3, 5\], got \(3, 4\)$"),
    "shape-any-length": (torch.zeros(3, 4), torch.float32, (None, 5), CPU,
                         ValueError, r"^t must be \[n, 5\], got \(3, 4\)$"),
    "contiguous": (torch.zeros(4, 3).t(), torch.float32, (3, 4), CPU,
                   ValueError, r"^t must be contiguous$"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_expect_refuses(case):
    t, dtype, shape, device, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        build.expect("t", t, dtype, shape, device)


class _Entry:
    """A stand-in for one ctypes function: records its calls and returns
    ``ret``."""

    def __init__(self, ret):
        self.ret, self.calls = ret, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


def _stand_in(monkeypatch, ret: int):
    """A Library of ``k.cu`` whose loader returns a stand-in library with
    the entry point ``k_launch`` (returning ``ret``) and its error string;
    also returns the stand-in and the list of loads and checks."""
    lib = type("StandIn", (), {})()
    lib.k_launch, lib.k_error_string = _Entry(ret), _Entry(b"bad thing")
    seen = []
    monkeypatch.setattr(build, "load",
                        lambda source: seen.append(("load", source)) or lib)
    binding = build.Library("k.cu", {"k_launch": "pi fq"},
                            check=lambda l: seen.append(("check", l)))
    return binding, lib, seen


def test_library_declares_its_entry_points_once(monkeypatch):
    binding, lib, seen = _stand_in(monkeypatch, 0)
    assert binding.bind() is lib and binding.bind() is lib
    assert seen == [("load", "k.cu"), ("check", lib)]
    assert lib.k_launch.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_longlong]
    assert lib.k_launch.restype is ctypes.c_int
    assert lib.k_error_string.argtypes == [ctypes.c_int]
    assert lib.k_error_string.restype is ctypes.c_char_p


def test_library_call_passes_tensors_as_pointers(monkeypatch):
    binding, lib, _ = _stand_in(monkeypatch, 0)
    t = torch.zeros(4)
    binding.call("k_launch", t, 3, 0.5, None)
    assert lib.k_launch.calls == [(t.data_ptr(), 3, 0.5, None)]


def test_library_call_raises_with_the_library_message(monkeypatch):
    binding, lib, _ = _stand_in(monkeypatch, 7)
    with pytest.raises(RuntimeError, match="^k_launch failed: bad thing$"):
        binding.call("k_launch", None, 0, 0.0, 0)
    assert lib.k_error_string.calls == [(7,)]


LETTERS = {"float": "f", "int": "i", "long long": "q"}


def c_entry_points(source: str) -> dict[str, str]:
    """Each ``extern "C"`` function of ``csrc/<source>``: its name -> its
    arguments in ``build.ARG_TYPES`` letters (a pointer ``p``), with the
    return type first, before a colon."""
    out = {}
    text = (build.CSRC / source).read_text()
    for ret, name, params in re.findall(
            r'extern "C"\s+(.+?)\s*\b(\w+)\s*\(([^)]*)\)', text):
        kinds = [re.sub(r"\s*\w+$", "", p.strip())
                 for p in params.split(",") if p.strip()]
        out[name] = ret.replace(" ", "") + ":" + "".join(
            "p" if k.endswith("*") else LETTERS[k.replace("const ", "")]
            for k in kinds)
    return out


@pytest.mark.parametrize("source", sorted(p.name
                                          for p in build.CSRC.glob("*.cu")))
def test_library_table_matches_the_c_declarations(source):
    """Every source has one Library, whose table holds each of its int
    entry points with the C arguments, and the source exports the error
    string the binding reads."""
    binding = LIBRARIES[source]
    declared = c_entry_points(source)
    stem = source.removesuffix(".cu")
    assert declared.pop(f"{stem}_error_string") == "constchar*:i"
    assert declared == {name: "int:" + args.replace(" ", "")
                        for name, args in binding.entries.items()}
