"""Port parity, the JAX package's last helpers: ``strip_lowerdiag_sym``
(utils/general.py), ``get_projection_matrix`` (utils/graphics.py) and
``sh_from_rgb_dc`` (utils/sh.py), each fed the same seeded numpy inputs in
both packages and compared bitwise (the same float32 operations, or the
same Python arithmetic stored as float32); and the check, by ``ast``,
that every public function and class of d2dgs_tpu/ has a counterpart of
the same name in the same module of d2dgs_torch/, but for the XLA- and
mesh-only ones listed with their reasons."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_torch.utils import general as tgeneral
from d2dgs_torch.utils import graphics as tgraphics
from d2dgs_torch.utils import sh as tsh
from d2dgs_tpu.utils import general as jgeneral
from d2dgs_tpu.utils import graphics as jgraphics
from d2dgs_tpu.utils import sh as jsh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", [(3, 3), (7, 3, 3), (2, 5, 3, 3)])
def test_strip_lowerdiag_sym_bitwise(shape):
    a = np.random.RandomState(sum(shape)).normal(size=shape).astype(
        np.float32)
    m = a + np.swapaxes(a, -1, -2)          # symmetric, as its callers pass
    got = tgeneral.strip_lowerdiag_sym(torch.from_numpy(m)).numpy()
    ref = np.asarray(jgeneral.strip_lowerdiag_sym(jnp.asarray(m)))
    assert got.shape == ref.shape == shape[:-2] + (6,)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_projection_matrix_exact(seed):
    rs = np.random.RandomState(seed)
    znear, zfar = float(rs.uniform(0.001, 0.5)), float(rs.uniform(5, 1000))
    fovx, fovy = (float(v) for v in rs.uniform(0.2, 2.5, size=2))
    got = tgraphics.get_projection_matrix(znear, zfar, fovx, fovy)
    ref = jgraphics.get_projection_matrix(znear, zfar, fovx, fovy)
    assert isinstance(got, np.ndarray)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3,), (16, 3), (4, 1, 3)])
def test_sh_from_rgb_dc_bitwise(shape):
    rgb = np.random.RandomState(len(shape)).uniform(size=shape).astype(
        np.float32)
    got = tsh.sh_from_rgb_dc(torch.from_numpy(rgb)).numpy()
    ref = np.asarray(jsh.sh_from_rgb_dc(jnp.asarray(rgb)))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# JAX-package public functions with no counterpart of the same name, each
# with its reason.
NO_COUNTERPART = {
    "utils/cache.py": (
        {"cache_dir", "host_fingerprint"},
        "XLA's persistent compile cache, keyed by host; the port's nvcc "
        "builds are keyed by source hash in ops/cuda/build.py"),
    "ops/pallas/blend_tpu.py": (
        {"blend_tiles_pallas", "blend_tiles_wq", "build_work_queue",
         "build_gdata"},
        "the Pallas launchers and their work queue; the port's kernels are "
        "ops/cuda/blend.py (blend_fwd, blend_bwd, segment_layout) and "
        "ops/cuda/blend_dense.py (build_gdata among them)"),
    "ops/tiled_raster.py": (
        {"blend_tiles_xla"},
        "the XLA route of the blend; the port's plain version is "
        "blend_tiles_plain"),
    "parallel/data_parallel.py": (
        {"make_mesh", "shard_batch", "shard_replicated"},
        "jax.sharding placement on one process's devices; the port's "
        "ranks are processes (parallel/multihost.py)"),
}


def _public_defs(path: Path) -> set[str]:
    if not path.exists():
        return set()
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_public_jax_function_has_a_counterpart():
    missing = {}
    for path in sorted((ROOT / "d2dgs_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "d2dgs_tpu").as_posix()
        lack = _public_defs(path) - _public_defs(ROOT / "d2dgs_torch" / rel)
        if lack:
            missing[rel] = lack
    assert missing == {k: v[0] for k, v in NO_COUNTERPART.items()}
