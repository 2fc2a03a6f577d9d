"""Port parity, the mesh rasterizer (d2dgs_torch/mesh/render.py) and the
OBJ reader: the cases of tests/test_mesh_render.py run against the port,
then the port against d2dgs_tpu/mesh/render.py on the same numpy inputs.

Tolerances: the winning face of every pixel equal but at edge ties
(a pixel centre on an edge two faces share, where XLA's roundings may
give the JAX package another covering face or the background;
``_agreeing_pixels`` checks each such pixel), image and depth to 1e-5
where the winners agree, but the colour of a covered pixel: that is
held to the first-order image of a 4-ulp rounding of each vertex's
screen position and depth through the perspective-correct barycentric
interpolation (``_colour_bound``), since XLA contracts the jitted edge
functions' multiply-adds otherwise than the port, and a sliver of the
TSDF mesh magnifies that by its inverse area.  Inside the port, the chunked z-buffer is bitwise the
unchunked one, and a mesh padded with zero-area faces renders bitwise
as the unpadded one."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.mesh import obj as jobj
from d2dgs_tpu.mesh import render as jrender
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.mesh import obj as tobj
from d2dgs_torch.mesh import render as tmr
from d2dgs_torch.mesh import tsdf as ttsdf
from d2dgs_torch.mesh.render import mesh_shape_render, render_mesh

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)


def cam(*a, **kw):
    return orbit_camera(*a, device="cpu", **kw)


def _front_quad(z=2.0, half=0.5):
    v = np.array([[-half, -half, 0], [half, -half, 0],
                  [half, half, 0], [-half, half, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def _np(*a):
    return [x.cpu().numpy() for x in a]


# --- the cases of tests/test_mesh_render.py, on the port ---------------

def test_render_mesh_color_depth_mask():
    c = cam(0.0, 0.0, 2.0, fov=0.8, H=64, W=64, time=0.0)
    verts, faces = _front_quad()
    cols = np.tile(np.array([[0.2, 0.6, 0.9]], np.float32),
                   (verts.shape[0], 1))
    img, depth, mask = _np(*render_mesh(c, verts, faces, cols,
                                        bg=torch.zeros(3)))
    assert np.allclose(img[32, 32], [0.2, 0.6, 0.9], atol=1e-3)
    assert abs(depth[32, 32] - 2.0) < 0.02
    assert mask[32, 32] == 1.0
    assert mask[0, 0] == 0.0 and np.all(img[0, 0] == 0.0)
    assert depth[0, 0] == 0.0


def test_render_mesh_occlusion():
    c = cam(0.0, 0.0, 3.0, fov=0.8, H=48, W=48, time=0.0)
    v1, f1 = _front_quad(half=0.3)
    v2, f2 = _front_quad(half=0.6)
    v2 = v2.copy()
    v2[:, 2] -= 1.0
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, f2 + 4])
    cols = np.concatenate([np.tile([[1.0, 0, 0]], (4, 1)),
                           np.tile([[0, 1.0, 0]], (4, 1))]).astype(
                               np.float32)
    img, _, _ = _np(*render_mesh(c, verts, faces, cols, bg=torch.zeros(3)))
    assert np.allclose(img[24, 24], [1, 0, 0], atol=1e-3)
    # row 17 is inside the far quad but outside the near one
    assert np.allclose(img[17, 24], [0, 1, 0], atol=1e-3)


def test_render_mesh_interpolates_vertex_colors():
    c = cam(0.0, 0.0, 2.0, fov=0.8, H=64, W=64, time=0.0)
    verts, faces = _front_quad()
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]],
                    np.float32)
    img, _, _ = _np(*render_mesh(c, verts, faces, cols, bg=torch.zeros(3)))
    center = img[32, 22]
    assert 0.05 < center.min() and center.max() < 0.95, center


def test_mesh_shape_render_shading():
    c = cam(0.0, 0.0, 2.0, fov=0.8, H=48, W=48, time=0.0)
    verts, faces = _front_quad()
    img, _, mask = _np(*mesh_shape_render(c, verts, faces))
    px = img[24, 24]
    assert np.all(px > 0.9) and abs(px[0] - px[1]) < 1e-5
    assert mask[24, 24] == 1.0


def test_render_mesh_supersample():
    c = cam(0.0, 0.0, 2.0, fov=0.8, H=32, W=32, time=0.0)
    verts, faces = _front_quad()
    cols = np.ones((4, 3), np.float32)
    img1, _, _ = _np(*render_mesh(c, verts, faces, cols, bg=torch.zeros(3)))
    img2, _, _ = _np(*render_mesh(c, verts, faces, cols, bg=torch.zeros(3),
                                  supersample=2))
    assert img2.shape == img1.shape
    frac = (img2[..., 0] > 0.05) & (img2[..., 0] < 0.95)
    assert frac.any()


# --- parity with the JAX package ---------------------------------------

def _sphere_mesh():
    """A small TSDF mesh: an ellipsoid's signed distance sampled on a
    grid, marched and welded by the port's extractor."""
    vol = ttsdf.make_volume((-0.7, -0.6, -0.5), (0.7, 0.6, 0.5),
                            voxel=0.06, device="cpu")
    X, Y, Z = vol.tsdf.shape
    g = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij"), -1) * 0.06 + \
        np.array([-0.7, -0.6, -0.5])
    r = np.linalg.norm(g / np.array([0.55, 0.45, 0.4]), axis=-1)
    sdf = np.clip((r - 1.0) * 0.4 / vol.sdf_trunc, -1, 1)
    vol.tsdf.copy_(torch.from_numpy(sdf.astype(np.float32)))
    vol.weight.fill_(1.0)
    verts, faces = ttsdf.extract_mesh(vol)
    rs = np.random.RandomState(3)
    return verts, faces, rs.uniform(size=verts.shape).astype(np.float32)


def _quads():
    v1, f1 = _front_quad(half=0.3)
    v2, f2 = _front_quad(half=0.6)
    v2 = v2.copy()
    v2[:, 2] -= 1.0
    cols = np.random.RandomState(1).uniform(size=(8, 3)).astype(np.float32)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4]), cols


SCENES = {"tsdf": (_sphere_mesh, dict(azimuth=0.7, elevation=0.3,
                                      radius=2.2, fov=0.8, H=56, W=64)),
          "quads": (_quads, dict(azimuth=0.0, elevation=0.0, radius=3.0,
                                 fov=0.8, H=48, W=48)),
          "quads_oblique": (_quads, dict(azimuth=0.5, elevation=0.25,
                                         radius=3.0, fov=0.8, H=48,
                                         W=40))}


def _jax_win(jcam, verts, faces):
    v, f, _ = jrender._subdivide_to_budget(
        verts, faces, np.zeros_like(verts), jcam, budget=32.0)
    uv, z = jrender._project(jcam, jnp.asarray(v))
    win, _ = jrender._raster_core(uv, z, jnp.asarray(f, jnp.int32),
                                  jcam.H, jcam.W, 16, 2)
    return np.asarray(win).reshape(jcam.H, jcam.W)


def _port_raster(tcam, verts, faces, chunk=tmr.FACE_CHUNK):
    """The port's (winner, z-buffer) per pixel of the subdivided mesh."""
    v, f, _ = tmr._subdivide_to_budget(verts, faces, np.zeros_like(verts),
                                       tcam, budget=32.0)
    uv, z = tmr._project(tcam, torch.from_numpy(v))
    win, zbuf = tmr._raster_core(uv, z, torch.from_numpy(f), tcam.H,
                                 tcam.W, 16, 2, chunk=chunk)
    return (win.reshape(tcam.H, tcam.W).numpy(),
            zbuf.reshape(tcam.H, tcam.W).numpy())


def _fragments_by_pixel(tcam, verts, faces):
    """{(y, x): [(depth, face), ...]}: every fragment of the port's
    rasterizer, one face at a time, on the subdivided mesh."""
    v, f, _ = tmr._subdivide_to_budget(verts, faces, np.zeros_like(verts),
                                       tcam, 32.0)
    uv, z = tmr._project(tcam, torch.from_numpy(v))
    tri_uv, tri_z = uv[torch.from_numpy(f)], z[torch.from_numpy(f)]
    offs = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32),
                                      indexing="xy"), -1).reshape(-1, 2)
    frags = {}
    for i in range(f.shape[0]):
        s = slice(i, i + 1)
        bb = torch.floor(torch.amin(tri_uv[s], dim=1))
        ext = torch.amax(torch.ceil(torch.amax(tri_uv[s], dim=1)) - bb)
        stride = torch.clamp_min(torch.ceil((ext + 1.0) / 32.0), 1.0)
        idx, zp = tmr._fragments(tri_uv[s], tri_z[s],
                                 torch.all(tri_z[s] > tmr._NEAR, dim=-1),
                                 bb, stride[None], offs.float(),
                                 tcam.H, tcam.W)
        keep = idx < tcam.H * tcam.W
        for p, d in zip(idx[keep].tolist(), zp[keep].tolist()):
            frags.setdefault(divmod(p, tcam.W), []).append((d, i))
    return frags


def _agreeing_pixels(jcam, tcam, verts, faces):
    """The pixels where both packages pick the same face.  Every other
    pixel must be an edge tie: a pixel centre on an edge two faces share,
    where more than one face's fragment lies within 1e-6 of the nearest
    depth.  There the port keeps the smallest id among the fragments at
    exactly the nearest depth, as both packages define the winner, while
    XLA rounds the JAX package's edge functions and second-pass depths
    otherwise than its first pass, so its pick is another face covering
    the pixel, or the background."""
    jw = _jax_win(jcam, verts, faces)
    tw = _port_raster(tcam, verts, faces)[0]
    diff = jw != tw
    frags = _fragments_by_pixel(tcam, verts, faces) if diff.any() else {}
    for y, x in np.argwhere(diff):
        fr = frags[y, x]
        dmin = min(d for d, _ in fr)
        near = [i for d, i in fr if d <= dmin * (1 + 1e-6)]
        assert len(near) > 1, (y, x, fr)
        assert tw[y, x] == min(i for d, i in fr if d == dmin), (y, x, fr)
        assert jw[y, x] in [i for _, i in fr] + [-1], (y, x, fr)
    assert ((tw >= 0) & ~diff).sum() > 50
    return ~diff


def _colour_bound(tcam, verts, faces, cols):
    """[H, W, 3] bound on the rounding of render_mesh's colour at each
    covered pixel: |d rgb / d x| times 4 ulps of |x| summed over each
    winning face's vertex screen positions and depths x (float64
    autograd through the port's barycentric interpolation), plus 4 ulps
    of the colour."""
    eps = 4 * np.finfo(np.float32).eps
    v, f, c = tmr._subdivide_to_budget(verts, faces, cols, tcam, 32.0)
    uv, z = tmr._project(tcam, torch.from_numpy(v))
    win = _port_raster(tcam, verts, faces)[0].reshape(-1)
    fw = torch.from_numpy(f)[torch.from_numpy(win).clamp_min(0)]
    xs = [uv.double()[fw[:, k]].requires_grad_(True) for k in range(3)]
    zs = [z.double()[fw[:, k]].requires_grad_(True) for k in range(3)]
    cs = [torch.from_numpy(c).double()[fw[:, k]] for k in range(3)]
    jj, ii = torch.meshgrid(torch.arange(tcam.H), torch.arange(tcam.W),
                            indexing="ij")
    p = torch.stack([ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5],
                    -1).double()
    a, b, cc = xs
    area = tmr._edge(a, b, cc)
    lam = [tmr._edge(b, cc, p) / area, tmr._edge(cc, a, p) / area,
           tmr._edge(a, b, p) / area]
    inv_z = sum(lam[k] / zs[k] for k in range(3))
    rgb = sum(lam[k][:, None] * cs[k] / zs[k][:, None]
              for k in range(3)) / inv_z[:, None]
    bound = []
    for ch in range(3):
        g = torch.autograd.grad(rgb[:, ch].sum(), xs + zs,
                                retain_graph=True)
        s = sum((g[k].abs() * xs[k].detach().abs().amax(-1, keepdim=True)
                 ).sum(-1) + g[3 + k].abs() * zs[k].detach().abs()
                for k in range(3))
        bound.append(eps * (s + rgb[:, ch].detach().abs()))
    return torch.stack(bound, -1).numpy().reshape(tcam.H, tcam.W, 3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_mesh_matches_jax(scene):
    make, kw = SCENES[scene]
    verts, faces, cols = make()
    assert faces.shape[0] > 0
    jcam, tcam = jorbit(**kw), cam(**kw)
    ji, jd, jm = map(np.asarray, jrender.render_mesh(
        jcam, verts, faces, cols, bg=jnp.asarray([0.1, 0.2, 0.3])))
    ti, td, tm = _np(*render_mesh(tcam, verts, faces, cols,
                                  bg=torch.tensor([0.1, 0.2, 0.3])))
    same = _agreeing_pixels(jcam, tcam, verts, faces)
    np.testing.assert_array_equal(tm[same], jm[same])
    hit = same & (tm > 0)
    np.testing.assert_array_equal(ti[same & (tm == 0)],
                                  ji[same & (tm == 0)])
    err = np.abs(ti[hit] - ji[hit])
    bound = _colour_bound(tcam, verts, faces, cols)[hit]
    assert (err <= bound).all(), (err.max(), (err / bound).max())
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_mesh_shape_render_matches_jax(scene):
    make, kw = SCENES[scene]
    verts, faces, _ = make()
    jcam, tcam = jorbit(**kw), cam(**kw)
    ji, jd, jm = map(np.asarray, jrender.mesh_shape_render(
        jcam, verts, faces))
    ti, td, tm = _np(*mesh_shape_render(tcam, verts, faces))
    # the shape render rasterizes the face-split mesh
    same = _agreeing_pixels(jcam, tcam, verts[faces].reshape(-1, 3),
                            np.arange(faces.size).reshape(-1, 3))
    np.testing.assert_array_equal(tm[same], jm[same])
    np.testing.assert_allclose(ti[same], ji[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)


def test_supersample_matches_jax():
    """Supersampling renders at 2x and pools each 2x2 block; the blocks
    without an edge tie agree."""
    verts, faces, cols = _sphere_mesh()
    kw = SCENES["tsdf"][1]
    jcam, tcam = jorbit(**kw), cam(**kw)
    ji, jd, jm = map(np.asarray, jrender.render_mesh(
        jcam, verts, faces, cols, supersample=2))
    ti, td, tm = _np(*render_mesh(tcam, verts, faces, cols, supersample=2))
    # the 2x cameras as render_mesh builds them
    j2, t2 = (dataclasses.replace(c, H=c.H * 2, W=c.W * 2, fx=c.fx * 2,
                                  fy=c.fy * 2) for c in (jcam, tcam))
    same2 = _agreeing_pixels(j2, t2, verts, faces)
    same = same2.reshape(kw["H"], 2, kw["W"], 2).all((1, 3))
    np.testing.assert_allclose(tm[same], jm[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ti[same], ji[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)


# --- the port's own invariants -----------------------------------------

def test_chunked_equals_unchunked():
    """Min is order-free: walking the faces in chunks smaller than the
    face count changes no bit of the z-buffer or the winners."""
    verts, faces, _ = _sphere_mesh()
    c = cam(**SCENES["tsdf"][1])
    win, zbuf = _port_raster(c, verts, faces, chunk=faces.shape[0] + 1)
    assert (win >= 0).sum() > 50
    for chunk in (7, 100):
        assert chunk < faces.shape[0]
        w, z = _port_raster(c, verts, faces, chunk=chunk)
        np.testing.assert_array_equal(w, win)
        np.testing.assert_array_equal(z, zbuf)


def test_padding_changes_nothing():
    """The JAX package's power-of-two padding (zero-area faces on vertex
    0, zero vertices) wins no pixel: the port drops it."""
    verts, faces, cols = _sphere_mesh()
    c = cam(**SCENES["tsdf"][1])
    pv, pf, pc = jrender._pad_pow2(verts, faces.astype(np.int64), cols)
    assert pf.shape[0] > faces.shape[0]
    for x, y in zip(_np(*render_mesh(c, verts, faces, cols)),
                    _np(*render_mesh(c, pv, pf, pc))):
        np.testing.assert_array_equal(x, y)
    win, zbuf = _port_raster(c, pv, pf)
    np.testing.assert_array_equal(win, _port_raster(c, verts, faces)[0])
    assert win.max() < faces.shape[0]


@pytest.mark.parametrize("n_verts", [0, 4])
def test_empty_mesh_renders_background(n_verts):
    """A mesh with no faces: the JAX package pads it to one zero-area
    face, which renders the background with zero depth and an empty mask;
    the port returns the same without padding."""
    kw = SCENES["quads"][1]
    jcam, tcam = jorbit(**kw), cam(**kw)
    verts = _front_quad()[0][:n_verts]
    faces = np.zeros((0, 3), np.int32)
    cols = np.ones((n_verts, 3), np.float32)
    bg = [0.1, 0.2, 0.3]
    j = jrender.render_mesh(jcam, verts, faces, cols, bg=jnp.asarray(bg))
    t = render_mesh(tcam, verts, faces, cols, bg=torch.tensor(bg))
    js = jrender.mesh_shape_render(jcam, verts, faces)
    ts = mesh_shape_render(tcam, verts, faces)
    for a, b in zip(_np(*t) + _np(*ts), list(j) + list(js)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(_np(t[0])[0],
                                  np.broadcast_to(np.float32(bg), (48, 48, 3)))


def test_load_obj_and_mtl(tmp_path):
    obj = tmp_path / "m.obj"
    mtl = tmp_path / "m.mtl"
    obj.write_text("# fixture\nmtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "v 0 0 1.5\nvn 0 0 1\nusemtl skin\nf 1/1/1 2/2/1 3/3/1\n"
                   "f 1 3 4\n")
    mtl.write_text("newmtl skin\nKa 0 0 0\nKd 0.25 0.5 0.75\n")
    for a, b in zip(tobj.load_obj(str(obj)), jobj.load_obj(str(obj))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    v, f = tobj.load_obj(str(obj))
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3]])
    assert v[3, 2] == 1.5
    tv, tf, tc = tobj.load_obj_mtl(str(obj), str(mtl))
    jv, jf, jc = jobj.load_obj_mtl(str(obj), str(mtl))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, np.tile([[0.25, 0.5, 0.75]], (6, 1)))


def test_render_mesh_trajectory(tmp_path, monkeypatch):
    """The per-frame mesh journey against the JAX package's
    render_mesh_trajectory on the same TrainState (the shell of surfels
    and control nodes of tests/test_torch_mesh.py, meshed through the
    node warp at t = 0.5 and voxel 0.12, where both packages fit the same
    grid), from two trajectory cameras.  Each frame's PLY has the same
    faces and vertices within 1e-5, the tolerance of the reconstruct_mesh
    tests.  The frames are each package's render of its own mesh, so they
    are compared where both rasterizers pick the same face (at least 98%
    of the covered pixels: a vertex ~1e-6 away moves an edge across a few
    pixel centres), and there 99% of the pixels agree to 1e-4 and the
    mean difference is below 1e-5 (the fused colours agree to 5e-5, and a
    sliver face turns the vertices' 1e-6 into larger barycentric
    changes)."""
    from d2dgs_tpu import native as jnative
    from d2dgs_tpu.eval.trajectories import \
        render_mesh_trajectory as jtraj
    from d2dgs_tpu.mesh.tsdf import load_mesh_ply as jload
    from d2dgs_torch import native as tnative
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.eval.trajectories import render_mesh_trajectory
    from d2dgs_torch.mesh.tsdf import load_mesh_ply
    from d2dgs_torch.train.config import TrainConfig
    from test_torch_mesh import MESH_CAMS, _mesh_scene

    # both packages' weld and filter on the port's build of
    # native/mesh_post.cpp, as tests/test_torch_mesh.py runs them
    monkeypatch.setattr(jnative, "_LIB", tnative._load())
    monkeypatch.setattr(jnative, "_TRIED", True)
    jcfg, js, tg, tn = _mesh_scene()
    tcfg = TrainConfig(sh_degree=0, hyper_dim=2, node_num=16,
                       raster=RasterConfig(tile_cap=256, chunk=64))
    masks = [np.concatenate([np.zeros((32, 12, 1)), np.ones((32, 20, 1))],
                            1).astype(np.float32) for _ in MESH_CAMS]
    traj = [dict(azimuth=a, elevation=0.2, radius=2.5, fov=0.9, H=40, W=40,
                 time=0.5) for a in (0.6, 2.4)]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jframes = jtraj([jorbit(**c) for c in traj],
                    [jorbit(**c) for c in MESH_CAMS], js.gauss, js.nodes,
                    jcfg.node_cfg, jcfg.raster, str(jdir), alpha_masks=masks,
                    voxel=0.12)
    tframes = render_mesh_trajectory(
        [cam(**c) for c in traj], [cam(**c) for c in MESH_CAMS], tg, tn,
        tcfg.node_cfg, tcfg.raster, str(tdir), alpha_masks=masks,
        voxel=0.12)
    assert [len(f) for f in tframes] == [len(f) for f in jframes] \
        == [len(traj)] * 2
    for i, c in enumerate(traj):
        name = f"mesh_{i:04d}.ply"
        jv, jf = jload(str(jdir / name))
        tv, tf = load_mesh_ply(str(tdir / name))
        assert tf.shape[0] > 1000
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
        split = np.arange(tf.size).reshape(-1, 3)
        # (image, shape): the shape render rasterizes the face-split mesh
        for k, (fv, ff) in enumerate(((jv, jf), (jv[jf].reshape(-1, 3),
                                                  split))):
            tw = _port_raster(cam(**c), (tv, tv[tf].reshape(-1, 3))[k],
                              ff)[0]
            same = _jax_win(jorbit(**c), fv, ff) == tw
            covered = int((tw >= 0).sum())
            assert covered > 300 and (~same).sum() <= 0.02 * covered
            d = np.abs(tframes[k][i] - np.asarray(jframes[k][i])).max(-1)
            assert (d[same] <= 1e-4).mean() >= 0.99, d[same].max()
            assert d[same].mean() < 1e-5
        for sub in ("mesh_image", "mesh_shape"):
            assert (tdir / sub / f"{i:04d}.png").exists()
    for gif in ("mesh_image.gif", "mesh_shape.gif"):
        assert (tdir / gif).exists()
