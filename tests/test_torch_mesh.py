"""Port parity, meshing: TSDF fusion, marching tetrahedra, colour
sampling, the cluster filter, the native library against its numpy
versions, and reconstruct_mesh, d2dgs_torch against d2dgs_tpu on the same
numpy inputs.

Fusion picks the same pixels on both sides (weights equal bit for bit);
XLA contracts some of the JAX package's multiply-adds into fused ones,
so the fused tsdf and colours are held to 1e-5 (a few float32 ulps of
values in [-1, 1]).  From one volume, extraction gives the same vertices
and faces bit for bit; from each package's own fused volume, the same
faces and vertices within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu import native as jnative
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.mesh import tsdf as jtsdf
from d2dgs_torch import native as tnative
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.mesh import tsdf as ttsdf

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

@pytest.fixture(scope="module", autouse=True)
def same_native_library():
    """Both packages' bindings on the port's build of native/mesh_post.cpp
    (one C ABI): the JAX binding builds native/ with make, which
    concurrent test workers can race, and its numpy fallback numbers the
    welded vertices in another order."""
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = tnative._load(), True
    yield
    jnative._LIB, jnative._TRIED = saved


VIEWS = [dict(azimuth=a, elevation=e, radius=3.0, fov=0.9, H=40, W=48)
         for a, e in ((0.0, 0.3), (1.7, -0.2), (3.3, 0.5), (4.6, 0.1))]
BOUNDS = ((-0.8, -0.75, -0.7), (0.85, 0.8, 0.75))


def sphere_depth(cam_kw, radius=0.55, center=(0.05, -0.03, 0.02)):
    """Per-pixel z-depth of a sphere seen by the JAX orbit camera, 0 where
    the ray misses (float64 maths, returned as float32)."""
    cam = jorbit(**cam_kw)
    w2c = np.asarray(cam.w2c, np.float64)
    H, W = cam.H, cam.W
    fx, fy = float(cam.fx), float(cam.fy)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    dirs = np.stack([(xs - W / 2) / fx, (ys - H / 2) / fy,
                     np.ones_like(xs)], -1)              # camera frame, z=1
    R, t = w2c[:3, :3], w2c[:3, 3]
    c = R @ np.asarray(center) + t                        # sphere centre
    a = np.sum(dirs * dirs, -1)
    b = -2 * dirs @ c
    disc = b * b - 4 * a * (c @ c - radius ** 2)
    z = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
    return np.where(disc > 0, z, 0.0).astype(np.float32)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for kw in VIEWS:
        depth = sphere_depth(kw)
        rgb = rs.uniform(size=(kw["H"], kw["W"], 3)).astype(np.float32)
        out.append((kw, depth, rgb))
    return out


def _fused(voxel):
    jvol = jtsdf.make_volume(*BOUNDS, voxel=voxel)
    tvol = ttsdf.make_volume(*BOUNDS, voxel=voxel, device="cpu")
    for kw, depth, rgb in _inputs():
        jvol = jtsdf.integrate_view(jvol, jnp.asarray(depth),
                                    jnp.asarray(rgb), jorbit(**kw))
        tvol = ttsdf.integrate_view(tvol, torch.from_numpy(depth),
                                    torch.from_numpy(rgb),
                                    orbit_camera(**kw, device="cpu"))
    return jvol, tvol


@pytest.fixture(scope="module")
def fused():
    return _fused(0.05)


FUSED = dict(rtol=0, atol=1e-5)


def test_integrate_view_matches_jax(fused):
    jvol, tvol = fused
    assert tuple(tvol.tsdf.shape) == jvol.tsdf.shape
    np.testing.assert_array_equal(tvol.origin.numpy(), np.asarray(jvol.origin))
    np.testing.assert_array_equal(tvol.weight.numpy(),
                                  np.asarray(jvol.weight))
    for f in ("tsdf", "color"):
        np.testing.assert_allclose(getattr(tvol, f).numpy(),
                                   np.asarray(getattr(jvol, f)),
                                   err_msg=f, **FUSED)
    assert float(tvol.weight.max()) >= 2   # voxels seen by several views
    assert bool((tvol.tsdf < 0).any()) and bool((tvol.tsdf > 0).any())


def _same_volume(jvol, tvol):
    """The JAX volume's arrays in the port's volume."""
    t = lambda a: torch.from_numpy(np.array(a))
    return tvol._replace(tsdf=t(jvol.tsdf), weight=t(jvol.weight),
                         color=t(jvol.color))


def test_integrate_view_slabs_change_no_value(fused, monkeypatch):
    """integrate_view's X-slabs are a memory bound, not a result."""
    _, tvol = fused
    monkeypatch.setattr(ttsdf, "SLAB_VOXELS", 37 * 5)
    vol = ttsdf.make_volume(*BOUNDS, voxel=0.05, device="cpu")
    for kw, depth, rgb in _inputs():
        vol = ttsdf.integrate_view(vol, torch.from_numpy(depth),
                                   torch.from_numpy(rgb),
                                   orbit_camera(**kw, device="cpu"))
    for f in ("tsdf", "weight", "color"):
        torch.testing.assert_close(getattr(vol, f), getattr(tvol, f),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("keep", [1, 2])
def test_extract_mesh_and_filter_match_jax(fused, keep):
    jvol, tvol = fused
    jv, jf = jtsdf.extract_mesh(jvol)
    tv, tf = ttsdf.extract_mesh(_same_volume(jvol, tvol))
    assert tf.shape[0] > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    jv2, jf2 = jtsdf.largest_components(jv, jf, keep=keep)
    tv2, tf2 = ttsdf.largest_components(tv, tf, keep=keep)
    np.testing.assert_array_equal(tv2, jv2)
    np.testing.assert_array_equal(tf2, jf2)
    # from the port's own fused volume
    tv3, tf3 = ttsdf.extract_mesh(tvol)
    np.testing.assert_array_equal(tf3, jf)
    np.testing.assert_allclose(tv3, jv, **FUSED)


def test_sample_colors_match_jax(fused):
    jvol, tvol = fused
    verts, _ = jtsdf.extract_mesh(jvol)
    jc = np.asarray(jtsdf.sample_colors(jvol, jnp.asarray(verts)))
    tc = ttsdf.sample_colors(_same_volume(jvol, tvol),
                             torch.from_numpy(verts)).numpy()
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)


def test_extract_mesh_slab_sizes_match_jax():
    """A finer grid, so some slabs hold many triangles: JAX's fixed
    per-slab buffer (tri_cap) against the port's sized-from-count one."""
    jvol, tvol = _fused(0.03)
    jv, jf = jtsdf.extract_mesh(jvol, tri_cap=20_000)
    tv, tf = ttsdf.extract_mesh(_same_volume(jvol, tvol))
    assert tf.shape[0] > 1000
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_mesh_ply_roundtrip_matches_jax(fused, tmp_path):
    _, tvol = fused
    v, f = ttsdf.extract_mesh(tvol)
    c = np.random.RandomState(1).uniform(size=v.shape).astype(np.float32)
    for colors in (None, c):
        ttsdf.save_mesh_ply(str(tmp_path / "t.ply"), v, f, colors=colors)
        jtsdf.save_mesh_ply(str(tmp_path / "j.ply"), v, f, colors=colors)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
        v2, f2 = ttsdf.load_mesh_ply(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(f2, f)


def _soup():
    # quad (2 tris sharing an edge), a far triangle, and a degenerate one
    return np.array([
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[1, 0, 0], [1, 1, 0], [0, 1, 0]],
        [[10, 10, 10], [11, 10, 10], [10, 11, 10]],
        [[5, 5, 5], [5, 5, 5], [6, 5, 5]],
    ], np.float32)


def test_native_library_matches_numpy_versions():
    """The C++ library (built from native/mesh_post.cpp by the port)
    against the port's numpy versions, and against the JAX binding."""
    if not tnative.available():
        pytest.skip("no C++ compiler: the numpy versions run instead")
    rs = np.random.RandomState(0)
    tris = np.concatenate([_soup(), _soup() + rs.randn(4, 3, 3) * 1e-7])
    v, f = tnative.weld_mesh(tris, 1e-4)
    vn, fn = tnative.weld_mesh_np(tris, 1e-4)
    assert v.shape == vn.shape == (9, 3) and f.shape == fn.shape == (6, 3)
    # the same welded mesh: numpy numbers vertices by key, the library
    # by first appearance
    order = np.lexsort(np.round(v / 1e-4).T[::-1])
    remap = np.empty(len(order), np.int64)
    remap[order] = np.arange(len(order))
    np.testing.assert_allclose(v[order], vn, atol=1e-6)
    np.testing.assert_array_equal(remap[f], fn)
    jv, jf = jnative.weld_mesh(tris, 1e-4)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)

    labels = tnative.connected_components(f, v.shape[0])
    labels_np = tnative.connected_components_np(f, v.shape[0])
    np.testing.assert_array_equal(labels, labels_np)  # both by first vertex
    for keep, ratio in ((1, 0.0), (1, 0.4), (2, 0.0)):
        v2, f2 = tnative.filter_components(v, f, keep, ratio)
        v3, f3 = tnative.filter_components_np(v, f, keep, ratio)
        assert f2.shape == f3.shape and v2.shape == v3.shape
        np.testing.assert_allclose(np.sort(v2[f2].reshape(len(f2), -1), 0),
                                   np.sort(v3[f3].reshape(len(f3), -1), 0))
    v2, f2 = tnative.filter_components(v, f, 1)
    assert f2.shape[0] == 4 and v2.shape[0] == 4   # the quad, twice
    v0, f0 = tnative.filter_components(np.zeros((0, 3), np.float32),
                                       np.zeros((0, 3), np.int32))
    assert v0.shape[0] == 0 and f0.shape[0] == 0


def test_native_builds_into_kernel_build():
    """The port builds its own copy of the library, under .kernel_build."""
    if not tnative.available():
        pytest.skip("no C++ compiler: the numpy versions run instead")
    lib = tnative.library_path()
    assert lib.exists() and ".kernel_build" in lib.parts
    assert lib.parent.parent == tnative.BUILD_ROOT


# ----------------------------------------------------------------------
# reconstruct_mesh: renders, masked depth, fusion, extraction, filter
# ----------------------------------------------------------------------

def _mesh_scene():
    """A shell of 300 opaque surfels on a sphere, and 16 control nodes,
    as a JAX TrainState and the port's Gaussians and nodes."""
    import dataclasses

    import jax

    from d2dgs_tpu.config import RasterConfig as JRasterConfig
    from d2dgs_tpu.models.gaussians import create_from_pcd
    from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
    from d2dgs_tpu.train.trainer import init_train_state
    from d2dgs_torch.io.from_jax import from_jax_arrays

    rs = np.random.RandomState(4)
    d = rs.normal(size=(300, 3))
    pts = (0.5 * d / np.linalg.norm(d, axis=-1, keepdims=True)
           ).astype(np.float32)
    cols = rs.uniform(size=(300, 3)).astype(np.float32)
    cfg = JTrainConfig(sh_degree=0, hyper_dim=2, node_num=16,
                       gaussian_capacity=384, node_gauss_capacity=64,
                       raster=JRasterConfig(tile_cap=256, chunk=64))
    js = init_train_state(jax.random.PRNGKey(0), cfg, pts, cols)
    g = create_from_pcd(pts, cols, 384, sh_degree=0, fea_dim=2)
    g = dataclasses.replace(
        g, scaling=jnp.where(g.alive[:, None], jnp.log(0.12), g.scaling),
        opacity=jnp.where(g.alive[:, None], 4.0, g.opacity),
        rotation=jnp.asarray(rs.normal(size=(384, 4)), jnp.float32))
    js = js._replace(gauss=g)
    leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(js)[0]}
    tg, tn = from_jax_arrays(leaves, device="cpu")
    return cfg, js, tg, tn


MESH_CAMS = [dict(azimuth=a, elevation=e, radius=2.5, fov=0.9, H=32, W=32,
                  time=0.5)
             for a, e in ((0.2, 0.3), (1.8, -0.3), (3.4, 0.4), (5.0, 0.0))]


@pytest.fixture(scope="module")
def mesh_scene():
    return _mesh_scene()


def _reconstruct(mesh_scene, deform_type, **kw):
    from d2dgs_tpu.mesh.extract import reconstruct_mesh as jrecon
    from d2dgs_tpu.models.deform import DeformConfig as JDeformConfig
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.mesh.extract import reconstruct_mesh as trecon
    from d2dgs_torch.models.deform import DeformConfig
    from d2dgs_torch.train.config import TrainConfig

    jcfg, js, tg, tn = mesh_scene
    tcfg = TrainConfig(sh_degree=0, hyper_dim=2, node_num=16,
                       raster=RasterConfig(tile_cap=256, chunk=64))
    jcams = [jorbit(**c) for c in MESH_CAMS]
    tcams = [orbit_camera(**c, device="cpu") for c in MESH_CAMS]
    # gt alpha masks: the right half of every view
    masks = [np.concatenate([np.zeros((32, 12, 1)), np.ones((32, 20, 1))],
                            1).astype(np.float32) for _ in MESH_CAMS]
    jout = jrecon(jcams, js.gauss, js.nodes, jcfg.node_cfg, jcfg.raster,
                  mesh_time=0.5, alpha_masks=masks, return_colors=True,
                  deform_cfg=JDeformConfig(deform_type=deform_type,
                                           node=jcfg.node_cfg), **kw)
    tout = trecon(tcams, tg, tn, tcfg.node_cfg, tcfg.raster, mesh_time=0.5,
                  alpha_masks=masks, return_colors=True,
                  deform_cfg=DeformConfig(deform_type=deform_type,
                                          node=tcfg.node_cfg), **kw)
    return jout, tout


def test_reconstruct_mesh_matches_jax(mesh_scene):
    """Explicit bounds, no deformation: the two packages' renders differ
    by their blends' rounding (images to 1e-5), so the vertices are held
    to 1e-5 with the same faces, and the fused vertex colours (running
    means of those images) to 5e-5."""
    (jv, jf, jc), (tv, tf, tc) = _reconstruct(
        mesh_scene, "static", bounds=((-0.8,) * 3, (0.8,) * 3), voxel=0.05)
    assert tf.shape[0] > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=5e-5)


def test_reconstruct_mesh_auto_bounds_match_jax(mesh_scene):
    """bounds="auto" through the node warp (whose d_xyz the packages
    round differently, ~1e-7): at a voxel where no box side lies near a
    whole number of voxels, both get the same grid and faces."""
    from d2dgs_torch.mesh.extract import auto_bounds
    from d2dgs_torch.models.deform import DeformConfig

    jcfg, js, tg, tn = mesh_scene
    voxel = 0.06
    lo, hi = auto_bounds(tg, tn, DeformConfig(node=jcfg.node_cfg), 0.5,
                         voxel)
    frac = (np.asarray(hi, np.float32) - np.asarray(lo, np.float32)) / voxel
    assert np.all(np.abs(frac - np.round(frac)) > 1e-3), frac
    (jv, jf, _), (tv, tf, _) = _reconstruct(mesh_scene, "node",
                                            voxel=voxel)
    assert tf.shape[0] > 50
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
