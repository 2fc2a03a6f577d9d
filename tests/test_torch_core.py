"""Port parity, core math: cameras, quaternions, SH, helpers, KNN and
preprocess of d2dgs_torch against d2dgs_tpu on the same numpy inputs."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data import cameras as jcams
from d2dgs_tpu.ops import knn as jknn
from d2dgs_tpu.ops.projection import preprocess as jpreprocess
from d2dgs_tpu.utils import general as jgeneral
from d2dgs_tpu.utils import quaternion as jquat
from d2dgs_tpu.utils import sh as jsh
from d2dgs_torch.data import cameras as tcams
from d2dgs_torch.ops import knn as tknn
from d2dgs_torch.ops.projection import preprocess as tpreprocess
from d2dgs_torch.utils import general as tgeneral
from d2dgs_torch.utils import quaternion as tquat
from d2dgs_torch.utils import sh as tsh

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another and make
# these small tensor ops many times slower.
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def T(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


CAMS = [dict(azimuth=0.4, elevation=0.3, radius=3.0, fov=0.8, H=48, W=64,
             time=0.25),
        dict(azimuth=-1.2, elevation=-0.5, radius=5.0, fov=0.5, H=37, W=61,
             time=0.9, target=(0.1, -0.2, 0.3))]


@pytest.mark.parametrize("kw", CAMS)
def test_orbit_camera_parity(kw):
    j = jcams.orbit_camera(**kw)
    t = tcams.orbit_camera(**kw, device="cpu")
    for f in ("w2c", "cam_center", "fx", "fy", "time", "K"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.H, t.W) == (j.H, j.W)


def test_make_camera_recentred_parity():
    rs = np.random.RandomState(3)
    R = np.linalg.qr(rs.normal(size=(3, 3)))[0]
    t = rs.normal(size=3)
    kw = dict(fovx=0.7, fovy=0.6, H=30, W=40, time=0.5,
              translate=np.array([0.1, 0.2, -0.3]), scale=1.7)
    j = jcams.make_camera(R, t, **kw)
    p = tcams.make_camera(R, t, **kw, device="cpu")
    for f in ("w2c", "cam_center", "fx", "fy", "time"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_quaternion_parity():
    q = np.random.RandomState(0).normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                       # dead capacity slot
    close(tquat.quat_normalize(T(q), eps=1e-12),
          jquat.quat_normalize(jnp.asarray(q), eps=1e-12))
    close(tquat.quat_to_rotmat(T(q)), jquat.quat_to_rotmat(jnp.asarray(q)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_parity(deg):
    rs = np.random.RandomState(deg)
    sh = rs.normal(size=(50, 16, 3)).astype(np.float32)
    d = rs.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # the JAX renderer passes the active degree as a traced int32 (band
    # mask); the port as an int (bands above it not built)
    jdeg = jnp.int32(deg)
    close(tsh.eval_sh(deg, T(sh), T(d)),
          jsh.eval_sh(jdeg, jnp.asarray(sh), jnp.asarray(d)))
    close(tsh.sh_to_rgb(deg, T(sh), T(d)),
          jsh.sh_to_rgb(jdeg, jnp.asarray(sh), jnp.asarray(d)))
    rgb = rs.uniform(size=(50, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(T(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def test_inverse_sigmoid_and_fps_parity():
    x = np.random.RandomState(1).uniform(0.01, 0.99, 40).astype(np.float32)
    close(tgeneral.inverse_sigmoid(T(x)), jgeneral.inverse_sigmoid(x))
    close(tgeneral.inverse_sigmoid(0.1), jgeneral.inverse_sigmoid(0.1))
    pts = np.random.RandomState(2).normal(size=(300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # the JAX start draw, passed in (PRNG streams differ across packages)
    start = int(jax.random.randint(key, (), 0, pts.shape[0]))
    j = jgeneral.farthest_point_sample(key, jnp.asarray(pts), 40)
    t = tgeneral.farthest_point_sample(T(pts), 40, start=start)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g = torch.Generator().manual_seed(0)
    t2 = tgeneral.farthest_point_sample(T(pts), 40, generator=g)
    assert t2.dtype == torch.int32 and len(set(t2.tolist())) == 40


def test_knn_parity():
    rs = np.random.RandomState(4)
    q = rs.normal(size=(70, 5)).astype(np.float32)
    r = rs.normal(size=(40, 5)).astype(np.float32)
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(r), 3, query_chunk=32)
    td, ti = tknn.knn(T(q), T(r), 3, query_chunk=32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(td, jd)
    close(tknn.mean_knn_sq_dist(T(q)),
          jknn.mean_knn_sq_dist(jnp.asarray(q)))


def _splats(n=160, seed=0):
    rs = np.random.RandomState(seed)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return [np.asarray(a, np.float32) for a in (means, scales, quats)]


@pytest.mark.parametrize("kw", CAMS)
def test_preprocess_parity(kw):
    means, scales, quats = _splats()
    j = jpreprocess(jnp.asarray(means), jnp.asarray(scales),
                    jnp.asarray(quats), jcams.orbit_camera(**kw), 1.3)
    t = tpreprocess(T(means), T(scales), T(quats),
                    tcams.orbit_camera(**kw, device="cpu"), 1.3)
    for f in ("radius", "valid", "rect_min", "rect_max"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("normal", "depth", "center"):
        close(getattr(t, f), getattr(j, f))
    # each row of T is a float32 product K @ [R s | p] whose terms reach
    # ~100 px; its rounding is relative to the row's scale, so compare
    # row-normalized to 1e-6
    jt = np.asarray(j.T)
    scale = np.abs(jt).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(t.T.numpy() / scale, jt / scale, **TOL)
    # extent = sqrt(cx^2 - f.Tu.Tu) cancels terms of ~1e4 px^2, so the
    # last-bit rounding of the two products reaches ~1e-3 px; its one
    # consumer, the integer radius, is equal above
    close(t.extent, j.extent, rtol=1e-6, atol=5e-3)


def test_entry_points_refuse_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tcams.orbit_camera(0.1, 0.2, 3.0, fov=0.8, H=8, W=8)
    with pytest.raises(RuntimeError, match="cuda"):
        tgeneral.resolve_device("cuda")
    # the command line: without --device cpu it exits non-zero, saying so
    from d2dgs_torch import cli
    for argv in (["train", "-s", "x", "-m", "y"], ["render", "-m", "y"],
                 ["mesh", "-m", "y"],
                 ["mesh-metrics", "--renders_dir", "r", "--gt_dir", "g"]):
        with pytest.raises(SystemExit, match="--device cpu") as e:
            cli.main(argv)
        assert e.value.code != 0
    # a model dir whose saved flags say --device cpu does not move a later
    # eval command off the card
    cli.save_cfg_args(str(tmp_path), argparse.Namespace(
        model_path=str(tmp_path), device="cpu"))
    for cmd in ("render", "mesh"):
        with pytest.raises(SystemExit, match="--device cpu") as e:
            cli.main([cmd, "-m", str(tmp_path)])
        assert e.value.code != 0
