"""Port parity, the articulated scene (d2dgs_torch/data/articulated.py):
the scene arrays bitwise equal to d2dgs_tpu's for a seed, the cases of
tests/test_articulated.py against the port, ``rotmat_to_quat`` and
``gt_gaussians`` to 1e-6, a small rendered dataset against the JAX
package's (run as tests/test_articulated.py runs it on the CPU) to image
rtol/atol 1e-5, and ``eval/mesh_metrics.score_mesh`` against the JAX
gate's scoring to rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data import articulated as jart
from d2dgs_tpu.utils.quaternion import rotmat_to_quat as jrotmat_to_quat
from d2dgs_torch.data import articulated as tart
from d2dgs_torch.utils.quaternion import rotmat_to_quat

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return tart.make_scene(0, 4_000)


@pytest.mark.parametrize("seed", [0, 7])
def test_scene_arrays_bitwise_equal_to_jax(seed):
    a = tart.make_scene(seed, 2_000)
    b = jart.make_scene(seed, 2_000)
    assert a.n_surfels == b.n_surfels
    np.testing.assert_array_equal(a.surfel_colors, b.surfel_colors)
    np.testing.assert_array_equal(a.surfel_radius, b.surfel_radius)
    assert [p.name for p in a.parts] == [p.name for p in b.parts]
    for pa, pb in zip(a.parts, b.parts):
        for f in ("pos", "nrm", "col"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
    for t in (0.0, 0.3, 4 / 7, 1.0):
        for x, y in zip(a.surfel_positions(t), b.surfel_positions(t)):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


# --- the cases of tests/test_articulated.py, on the port ---------------

def test_geometry_sane(scene):
    for t in (0.0, 0.3, 0.7, 1.0):
        p, n = scene.surfel_positions(t)
        assert p.shape == (scene.n_surfels, 3) and n.shape == p.shape
        assert np.isfinite(p).all() and np.isfinite(n).all()
        assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-3)
        assert (np.abs(p) < 2.0).all()
    assert scene.surfel_colors.shape == (scene.n_surfels, 3)
    assert (scene.surfel_colors >= 0).all() and \
        (scene.surfel_colors <= 1).all()


def test_deterministic():
    pa, _ = tart.make_scene(0, 2_000).surfel_positions(0.4)
    pb, _ = tart.make_scene(0, 2_000).surfel_positions(0.4)
    np.testing.assert_array_equal(pa, pb)


def test_motion_nonrigid(scene):
    p0, _ = scene.surfel_positions(0.0)
    p5, _ = scene.surfel_positions(0.5)
    d = np.linalg.norm(p5 - p0, axis=1)
    assert (d > 0.05).mean() > 0.4
    assert d.max() > 0.5
    assert d.std() > 0.1


def test_motion_every_sampled_time(scene):
    times = [i / 7 for i in range(8)]
    for t1, t2 in zip(times[:-1], times[1:]):
        p1, _ = scene.surfel_positions(t1)
        p2, _ = scene.surfel_positions(t2)
        assert np.linalg.norm(p2 - p1, axis=1).max() > 0.02


def test_gt_gaussians_render():
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.render.renderer import render

    g = tart.gt_gaussians(tart.make_scene(0, 2_000), 0.25, device="cpu")
    cam = orbit_camera(0.5, 0.2, 3.6, fov=0.72, H=96, W=96, time=0.25,
                       device="cpu")
    with torch.no_grad():
        out = render(cam, g, torch.zeros(3),
                     cfg=RasterConfig(tile_cap=512, chunk=64))
    assert torch.isfinite(out.image).all()
    assert int(out.overflow) == 0
    assert (out.alpha > 0.5).float().mean() > 0.05


# --- parity of the torch parts -----------------------------------------

def test_rotmat_to_quat_matches_jax():
    rs = np.random.RandomState(0)
    q = rs.randn(512, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # near-180-degree turns about each axis pick the x, y and z pivots
    q[:3] = [[1e-4, 1, 0, 0], [1e-4, 0, 1, 0], [1e-4, 0, 0, 1]]
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2).astype(np.float32)
    got = rotmat_to_quat(torch.from_numpy(R)).numpy()
    want = np.asarray(jrotmat_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the round trip: the same rotation up to sign, w >= 0
    qs = q * np.where(q[:, :1] < 0, -1, 1)
    np.testing.assert_allclose(got, qs, atol=1e-3)


@pytest.mark.parametrize("capacity", [0, 2_500])
def test_gt_gaussians_match_jax(capacity):
    sc = tart.make_scene(0, 2_000)
    t_g = tart.gt_gaussians(sc, 0.3, capacity=capacity, device="cpu")
    j_g = jart.gt_gaussians(jart.make_scene(0, 2_000), 0.3,
                            capacity=capacity)
    cap = capacity or sc.n_surfels
    assert t_g.capacity == cap
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "feature"):
        a = getattr(t_g, f).detach().numpy()
        b = np.asarray(getattr(j_g, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(t_g.alive.numpy(), np.asarray(j_g.alive))
    assert t_g.active_sh_degree == 0 and t_g.max_sh_degree == 0
    assert not t_g.with_motion_mask
    if capacity:
        dead = t_g.rotation.detach().numpy()[sc.n_surfels:]
        np.testing.assert_array_equal(dead, np.tile([1, 0, 0, 0],
                                                    (cap - sc.n_surfels, 1)))


def test_articulated_dataset_matches_jax():
    kw = dict(n_cams=2, n_times=2, H=64, W=64, n_surfels=2_000)
    tc, ti, ta, tsc, tt = tart.make_articulated_dataset(0, device="cpu",
                                                        **kw)
    jc, ji, ja, jsc, jt = jart.make_articulated_dataset(0, **kw)
    assert tt == jt and len(tc) == len(jc) == 4
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.w2c.numpy(), np.asarray(b.w2c),
                                   rtol=1e-6, atol=1e-6)
        assert float(a.time) == float(b.time)
    for a, b in zip(ti + ta, ji + ja):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    assert all(float(a.max()) > 0.5 for a in ta)


def test_score_mesh_matches_the_jax_gate():
    """``score_mesh`` against the JAX gate's scoring
    (tools/convergence_bench.py ``score_meshes``) on the same mesh and
    ground truth: chamfer, both one-sided means and the per-part means to
    rtol 1e-5."""
    from d2dgs_tpu.eval.mesh_metrics import sample_mesh_surface
    from d2dgs_tpu.ops.knn import knn
    from d2dgs_torch.eval.mesh_metrics import score_mesh

    sc = tart.make_scene(0, 2_000)
    gt, _ = sc.surfel_positions(0.4)
    rs = np.random.RandomState(5)
    verts = (gt[rs.choice(len(gt), 300, replace=False)]
             + rs.normal(0, 0.01, (300, 3))).astype(np.float32)
    faces = rs.randint(0, 300, (500, 3)).astype(np.int32)
    parts = [(p.name, len(p.pos)) for p in sc.parts]
    got = score_mesh(verts, faces, gt, parts, n_samples=1_500, device="cpu")

    pred = sample_mesh_surface(verts, faces, 1_500)
    sub = gt[np.random.RandomState(0).choice(len(gt), 1_500, replace=False)]
    a, b = jnp.asarray(pred), jnp.asarray(sub)
    mean_d = lambda q, r: float(jnp.mean(jnp.sqrt(jnp.maximum(
        knn(q, r, 1)[0], 0.0))))
    d_pg, d_gp = mean_d(a, b), mean_d(b, a)
    np.testing.assert_allclose(got["pred_to_gt"], d_pg, rtol=1e-5)
    np.testing.assert_allclose(got["gt_to_pred"], d_gp, rtol=1e-5)
    np.testing.assert_allclose(got["chamfer"], d_pg + d_gp, rtol=1e-5)
    d_all = np.sqrt(np.maximum(np.asarray(knn(jnp.asarray(gt), a, 1)[0]),
                               0.0))[:, 0]
    off = 0
    for name, k in parts:
        np.testing.assert_allclose(got["by_part"][name],
                                   d_all[off:off + k].mean(), rtol=1e-5)
        off += k
    assert score_mesh(verts, faces[:0], gt, parts,
                      device="cpu")["chamfer"] == float("inf")
