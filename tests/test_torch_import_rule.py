"""The port's import rule: no module of d2dgs_torch/, not chip_smoke.py
and not the port's tools (tools/convergence_torch.py,
tools/raster3d_profile.py) imports jax, jaxlib or the JAX package
d2dgs_tpu, at module level or inside a function (the port must run where
only torch and CUDA exist); and no module of d2dgs_torch/ops/cuda/ takes
an underscore name from a sibling (what the launchers share is public:
build.py's binding, blend.py's work layout and launches).
Read with ast, so nothing is imported to check it."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "d2dgs_tpu")
FILES = sorted((ROOT / "d2dgs_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "convergence_torch.py",
    ROOT / "tools" / "raster3d_profile.py"]
CUDA_PACKAGE = "d2dgs_torch.ops.cuda"
CUDA_MODULES = sorted((ROOT / "d2dgs_torch" / "ops" / "cuda").glob("*.py"))


def forbidden_imports(source: str) -> list[str]:
    """Every import of a forbidden top-level package in ``source``: import
    and from-import statements anywhere in the tree, and __import__ /
    importlib.import_module calls with a literal name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("__import__", "import_module"):
                names = [node.args[0].value]
        for n in names:
            if n.split(".")[0] in FORBIDDEN:
                found.append(f"line {node.lineno}: {n}")
    return found


def test_rule_catches_every_form():
    src = ("import os\nimport jax.numpy as jnp\nfrom jaxlib import x\n"
           "def f():\n    from d2dgs_tpu.cli import main\n"
           "    import importlib\n    importlib.import_module('jax')\n"
           "    return __import__('d2dgs_tpu.ops')\n"
           "from . import jax_like\nimport jaxtyping\n")
    assert [s.split(": ")[1] for s in forbidden_imports(src)] == [
        "jax.numpy", "jaxlib", "d2dgs_tpu.cli", "jax", "d2dgs_tpu.ops"]


def test_the_port_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for m in ("d2dgs_torch/cli.py", "d2dgs_torch/data/dnerf.py",
              "d2dgs_torch/mesh/tsdf.py", "d2dgs_torch/native/__init__.py",
              "d2dgs_torch/mesh/render.py", "d2dgs_torch/data/articulated.py",
              "d2dgs_torch/data/colmap.py", "chip_smoke.py",
              "tools/convergence_torch.py", "d2dgs_torch/ops/raster3d.py",
              "tools/raster3d_profile.py"):
        assert m in names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_module_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


def private_sibling_names(source: str) -> list[str]:
    """Every underscore name that ``source``, a module of ops/cuda/, takes
    from a sibling: ``from .m import _x`` (or from the absolute
    d2dgs_torch.ops.cuda.m), ``from . import _m``, and ``m._x`` on a
    sibling bound by ``from . import m``."""
    found, siblings = [], set()
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or not (
                node.level == 1 or (node.level == 0 and (
                    node.module or "").startswith(CUDA_PACKAGE + "."))):
            continue
        for a in node.names:
            if a.name.startswith("_"):
                found.append(f"line {node.lineno}: from {'.' * node.level}"
                             f"{node.module or ''} import {a.name}")
            elif node.module is None:
                siblings.add(a.asname or a.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in siblings and node.attr.startswith("_"):
            found.append(f"line {node.lineno}: {node.value.id}.{node.attr}")
    return found


def test_private_rule_catches_every_form():
    src = ("from __future__ import annotations\nfrom .. import blend\n"
           "from .blend import SEG, _check\nfrom . import build, _m\n"
           "from d2dgs_torch.ops.cuda.raster3d import _ptr\n"
           "from d2dgs_torch.ops.tiled_raster import _tile_pixels\n"
           "def f():\n    build._lib()\n    return blend._x, build.expect\n")
    assert [s.split(": ")[1] for s in private_sibling_names(src)] == [
        "from .blend import _check", "from . import _m",
        "from d2dgs_torch.ops.cuda.raster3d import _ptr", "build._lib"]


@pytest.mark.parametrize(
    "path", CUDA_MODULES,
    ids=[p.relative_to(ROOT).as_posix() for p in CUDA_MODULES])
def test_cuda_module_takes_no_private_name_from_a_sibling(path):
    assert private_sibling_names(path.read_text()) == []
