"""The port's import rule: no module of d2dgs_torch/ and not chip_smoke.py
imports jax, jaxlib or the JAX package d2dgs_tpu, at module level or
inside a function (the port must run where only torch and CUDA exist).
Read with ast, so nothing is imported to check it."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "d2dgs_tpu")
FILES = sorted((ROOT / "d2dgs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
              "chip_smoke.py"):
        assert m in names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_module_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []
