"""Mesh re-rendering (counterpart of d2dgs_tpu/mesh/render.py; the
reference's mesh_renderer/__init__.py:67-225 renders extracted meshes
with nvdiffrast for ``mesh_image/`` and a pytorch3d SoftPhong gray
"shape" render for ``mesh_shape/``).

A scatter z-buffer in plain PyTorch, on the camera's device:

  pass 1  per (triangle, patch pixel): coverage and perspective-correct
          depth, reduced into one z-buffer over flat pixel ids
          (``scatter_reduce_`` "amin" from +inf)
  pass 2  the winning triangle per pixel: the smallest triangle id among
          the fragments whose depth equals the z-buffer's
  pass 3  per-pixel barycentric attribute interpolation from the winner

Every triangle rasterizes a (patch·splits)² pixel patch anchored at its
screen box (1,024 fragments at the defaults); a triangle larger than the
patch is sampled at a coarser stride, and ``render_mesh`` first
subdivides such triangles on the host so every pixel is covered.

Memory: both passes walk the faces in chunks of ``FACE_CHUNK`` (2^15)
triangles, so a pass holds the fragments of one chunk only: 33.5M
fragments at the defaults, in a dozen [chunk, 1024] temporaries of 4 or
8 bytes each, beside the z-buffer and winner arrays of H·W+1 entries.
The peak above the inputs was 3.1 GB for a 517,503-face mesh at
800x800 on an H100 (``chip_smoke.py`` phase 7 prints it).
The JAX package builds all F·1024 fragments at once, 4.3G for a
voxel-0.004 mesh of 2.7M faces padded to 2^22, which would not fit on
an 80 GB card.  Min is order-free, so the chunked z-buffer and winners
are bitwise those of one pass over all faces.  Pass 2 recomputes each
fragment's depth with the same function as pass 1, so its equality test
against the z-buffer sees the same bits.  The JAX package pads the face
and vertex counts to powers of two to bound XLA recompiles; eager
PyTorch has none, and a zero-area face never covers a pixel, so the
port does not pad; a mesh with no faces renders the background, as the
JAX package's one padded face does.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..data.cameras import Camera
from ..ops.projection import matmul_fma

_NEAR = 0.01
FACE_CHUNK = 1 << 15
_NO_TRI = 2 ** 30


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _project(cam: Camera, verts: torch.Tensor):
    """world verts [V,3] -> (screen uv [V,2], camera z [V])."""
    pc = (matmul_fma(verts[:, None, :], cam.w2c[:3, :3].T)[:, 0]
          + cam.w2c[:3, 3])
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = pc[:, 0] / zs * cam.fx + cam.W / 2.0
    v = pc[:, 1] / zs * cam.fy + cam.H / 2.0
    return torch.stack([u, v], -1), z


def _edge(a, b, p):
    """2x signed area of triangle (a, b, p); p may broadcast."""
    return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))


def _fragments(tri_uv, tri_z, visible, bb_min, stride, offs, H: int,
               W: int):
    """One chunk's fragments: (flat pixel id [f*K] int64, H*W for a
    fragment that covers nothing; depth [f*K], +inf there).  Both passes
    call this, so a fragment's depth has the same bits in each."""
    a, b, c = (tri_uv[:, j:j + 1, :] for j in range(3))    # [f,1,2]
    pix = bb_min[:, None, :] + offs[None] * stride[:, None, None]  # [f,K,2]
    p = pix + 0.5                                          # pixel centres
    area = _edge(a, b, c)                                  # [f,1]
    sgn = torch.where(area >= 0, 1.0, -1.0)
    w0 = _edge(b, c, p) * sgn
    w1 = _edge(c, a, p) * sgn
    w2 = _edge(a, b, p) * sgn
    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
              & (torch.abs(area) > 1e-12))
    denom = torch.clamp_min(torch.abs(area), 1e-12)
    # perspective-correct depth: interpolate 1/z
    inv_z = (w0 / denom / tri_z[:, 0:1] + w1 / denom / tri_z[:, 1:2]
             + w2 / denom / tri_z[:, 2:3])
    zp = 1.0 / torch.clamp_min(inv_z, 1e-12)
    ui = torch.floor(pix[..., 0]).to(torch.int64)
    vi = torch.floor(pix[..., 1]).to(torch.int64)
    ok = (inside & visible[:, None] & (ui >= 0) & (ui < W)
          & (vi >= 0) & (vi < H))
    idx = torch.where(ok, vi * W + ui, H * W)
    return idx.reshape(-1), torch.where(ok, zp, torch.inf).reshape(-1)


def _raster_core(uv, z, faces, H: int, W: int, patch: int, splits: int,
                 chunk: int = FACE_CHUNK):
    """Returns (win_tri [H*W] int64, -1 = background; zbuf [H*W])."""
    dev = uv.device
    F = faces.shape[0]
    tri_uv = uv[faces]                                     # [F,3,2]
    tri_z = z[faces]                                       # [F,3]
    visible = torch.all(tri_z > _NEAR, dim=-1)
    bb_min = torch.floor(torch.amin(tri_uv, dim=1))        # [F,2]
    bb_max = torch.ceil(torch.amax(tri_uv, dim=1))
    ext = torch.amax(bb_max - bb_min, dim=-1)              # [F]
    # stride 1 for patch-sized triangles, coarser for big ones
    npix = float(patch * splits)
    stride = torch.clamp_min(torch.ceil((ext + 1.0) / npix), 1.0)
    n = patch * splits
    py, px = torch.meshgrid(torch.arange(n, device=dev),
                            torch.arange(n, device=dev), indexing="ij")
    offs = torch.stack([px, py], -1).reshape(-1, 2).to(torch.float32)

    def frags(f0):
        s = slice(f0, min(f0 + chunk, F))
        return _fragments(tri_uv[s], tri_z[s], visible[s], bb_min[s],
                          stride[s], offs, H, W)

    zbuf = torch.full((H * W + 1,), torch.inf, dtype=torch.float32,
                      device=dev)
    for f0 in range(0, F, chunk):
        idx, zp = frags(f0)
        zbuf.scatter_reduce_(0, idx, zp, "amin", include_self=True)
    zbuf = zbuf[:-1]
    win = torch.full((H * W + 1,), _NO_TRI, dtype=torch.int64, device=dev)
    k = offs.shape[0]
    for f0 in range(0, F, chunk):
        idx, zp = frags(f0)
        hit = (zp <= zbuf[torch.clamp(idx, 0, H * W - 1)]) & (idx < H * W)
        tid = torch.arange(f0, min(f0 + chunk, F), device=dev
                           ).repeat_interleave(k)
        win.scatter_reduce_(0, idx, torch.where(hit, tid, _NO_TRI), "amin",
                            include_self=True)
    win = win[:-1]
    return torch.where(win >= _NO_TRI, -1, win), zbuf


def _shade(cam: Camera, verts, faces, colors, bg, patch: int, splits: int):
    H, W = cam.H, cam.W
    if faces.shape[0] == 0:
        # the background, as the JAX package's one padded zero-area face
        # renders it
        return (bg[None, None, :].expand(H, W, -1).clone(),
                torch.zeros((H, W), device=bg.device),
                torch.zeros((H, W), device=bg.device))
    uv, z = _project(cam, verts)
    win_tri, zbuf = _raster_core(uv, z, faces, H, W, patch, splits)

    f = faces[torch.clamp(win_tri, 0, faces.shape[0] - 1)]  # [HW,3]
    a, b, c = uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]]
    za, zb, zc = z[f[:, 0]], z[f[:, 1]], z[f[:, 2]]
    jj, ii = torch.meshgrid(torch.arange(H, device=uv.device),
                            torch.arange(W, device=uv.device), indexing="ij")
    p = torch.stack([ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5], -1)
    area = _edge(a, b, c)
    denom = torch.where(torch.abs(area) < 1e-12, 1e-12, area)
    l0 = _edge(b, c, p) / denom
    l1 = _edge(c, a, p) / denom
    l2 = _edge(a, b, p) / denom
    inv_z = torch.clamp_min(l0 / za + l1 / zb + l2 / zc, 1e-12)
    # perspective-correct vertex-attribute interpolation
    ca, cb, cc = colors[f[:, 0]], colors[f[:, 1]], colors[f[:, 2]]
    rgb = (l0[:, None] * ca / za[:, None] + l1[:, None] * cb / zb[:, None]
           + l2[:, None] * cc / zc[:, None]) / inv_z[:, None]
    hitm = win_tri >= 0
    img = torch.where(hitm[:, None], rgb, bg[None, :])
    depth = torch.where(hitm, zbuf, 0.0)
    return (img.reshape(H, W, -1), depth.reshape(H, W),
            hitm.reshape(H, W).to(torch.float32))


def _subdivide_to_budget(verts, faces, colors, cam: Camera, budget: float,
                         max_rounds: int = 10):
    """Host midpoint subdivision of the triangles whose screen box exceeds
    the per-triangle sample budget, so ``_raster_core`` covers every pixel
    with stride 1.  Exact for this renderer: the geometry is unchanged
    and midpoint colours are the linear interpolation the perspective-
    correct barycentric shading gives."""
    verts = _host(verts, np.float32)
    faces = _host(faces, np.int64)
    colors = _host(colors, np.float32)
    w2c = cam.w2c.cpu().numpy()
    for _ in range(max_rounds):
        pc = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-8, 1e-8, z)
        u = pc[:, 0] / zs * float(cam.fx) + cam.W / 2.0
        v = pc[:, 1] / zs * float(cam.fy) + cam.H / 2.0
        # clamp to a margin around the image so off-screen geometry does
        # not drive unbounded subdivision
        u = np.clip(u, -cam.W, 2 * cam.W)
        v = np.clip(v, -cam.H, 2 * cam.H)
        uv = np.stack([u, v], -1)
        tri_uv = uv[faces]
        vis = (z[faces] > _NEAR).all(-1)
        ext = (tri_uv.max(1) - tri_uv.min(1)).max(-1)
        big = vis & (ext + 1.0 > budget)
        if not big.any():
            break
        fb = faces[big]
        nv = verts.shape[0]
        mids, mcols = [], []
        for a, b in ((0, 1), (1, 2), (2, 0)):
            mids.append((verts[fb[:, a]] + verts[fb[:, b]]) * 0.5)
            mcols.append((colors[fb[:, a]] + colors[fb[:, b]]) * 0.5)
        verts = np.concatenate([verts] + mids)
        colors = np.concatenate([colors] + mcols)
        k = fb.shape[0]
        m01 = nv + np.arange(k)
        m12 = nv + k + np.arange(k)
        m20 = nv + 2 * k + np.arange(k)
        new = np.concatenate([
            np.stack([fb[:, 0], m01, m20], -1),
            np.stack([fb[:, 1], m12, m01], -1),
            np.stack([fb[:, 2], m20, m12], -1),
            np.stack([m01, m12, m20], -1)])
        faces = np.concatenate([faces[~big], new])
    return verts, faces.astype(np.int64), colors


def render_mesh(cam: Camera, verts, faces, vert_colors, bg=None,
                patch: int = 16, splits: int = 2, supersample: int = 1):
    """Vertex-colour mesh render (mesh_renderer/__init__.py:67-130
    ``render_mesh``) on the camera's device: returns (rgb [H,W,3],
    depth [H,W], mask [H,W]) tensors."""
    dev = cam.device
    verts, faces, vert_colors = _subdivide_to_budget(
        verts, faces, vert_colors, cam,
        budget=float(patch * splits) / max(int(supersample), 1))
    verts = torch.as_tensor(verts, device=dev)
    faces = torch.as_tensor(faces, device=dev)
    vert_colors = torch.as_tensor(vert_colors, device=dev)
    bg = (torch.ones(3, device=dev) if bg is None  # the reference's white
          else torch.as_tensor(bg, dtype=torch.float32, device=dev))
    ss = int(supersample)
    rcam = cam if ss == 1 else dataclasses.replace(
        cam, H=cam.H * ss, W=cam.W * ss, fx=cam.fx * ss, fy=cam.fy * ss)
    with torch.no_grad():
        img, depth, mask = _shade(rcam, verts, faces, vert_colors, bg,
                                  patch, splits)
    if ss > 1:
        img = img.reshape(cam.H, ss, cam.W, ss, 3).mean((1, 3))
        mask = mask.reshape(cam.H, ss, cam.W, ss).mean((1, 3))
        # min-pool depth so silhouette pixels keep a foreground value
        d = depth.reshape(cam.H, ss, cam.W, ss)
        dv = torch.where(d > 0, d, torch.inf).amin((1, 3))
        depth = torch.where(torch.isinf(dv), 0.0, dv)
    return img, depth, mask


def mesh_shape_render(cam: Camera, verts, faces, bg=None,
                      patch: int = 16, splits: int = 2,
                      supersample: int = 1):
    """Gray shaded "shape" render (mesh_renderer/__init__.py:139-225:
    SoftPhong with a headlight): flat per-face normals, the light at the
    camera, double-sided diffuse plus ambient."""
    dev = cam.device
    verts = torch.as_tensor(_host(verts, np.float32), device=dev)
    faces = torch.as_tensor(_host(faces, np.int64), device=dev)
    va, vb, vc = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(vb - va, vc - va)
    fn = fn / torch.clamp_min(torch.linalg.norm(fn, dim=-1, keepdim=True),
                              1e-12)
    centroid = (va + vb + vc) / 3.0
    to_cam = cam.cam_center[None, :] - centroid
    to_cam = to_cam / torch.clamp_min(
        torch.linalg.norm(to_cam, dim=-1, keepdim=True), 1e-12)
    diff = torch.abs(torch.sum(fn * to_cam, dim=-1))
    shade = torch.clamp(0.3 + 0.7 * diff, 0.0, 1.0)
    # a constant colour per face, on the vertices of a face-split mesh
    v_split = torch.stack([va, vb, vc], 1).reshape(-1, 3)
    f_split = torch.arange(faces.shape[0] * 3, device=dev).reshape(-1, 3)
    c_split = shade[:, None, None].expand(-1, 3, 3).reshape(-1, 3)
    return render_mesh(cam, v_split, f_split, c_split, bg=bg, patch=patch,
                       splits=splits, supersample=supersample)


def write_mesh_renders(cam: Camera, verts, faces, colors, out_dir: str,
                       i: int, report: dict | None = None):
    """Renders the mesh from ``cam`` with ``render_mesh`` (vertex colours)
    and ``mesh_shape_render`` (gray shading), writes them as
    ``out_dir/mesh_image/NNNN.png`` and ``out_dir/mesh_shape/NNNN.png``
    and returns the two images as host arrays.  With ``report``, each
    render's wall time in ms, the device synchronised before and after,
    goes into it as ``render_mesh_ms`` and ``mesh_shape_ms``."""
    from PIL import Image

    def sync():
        if cam.device.type == "cuda":
            torch.cuda.synchronize(cam.device)

    frames = []
    for sub, key, fn in (
            ("mesh_image", "render_mesh_ms",
             lambda: render_mesh(cam, verts, faces, colors)[0]),
            ("mesh_shape", "mesh_shape_ms",
             lambda: mesh_shape_render(cam, verts, faces)[0])):
        sync()
        t0 = time.perf_counter()
        img = fn()
        sync()
        if report is not None:
            report[key] = (time.perf_counter() - t0) * 1e3
        img = img.cpu().numpy()
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:04d}.png"))
        frames.append(img)
    return tuple(frames)
