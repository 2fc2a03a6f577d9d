"""TSDF fusion and isosurface extraction (counterpart of
d2dgs_tpu/mesh/tsdf.py; the reference fuses masked depth maps with
Open3D's ScalableTSDFVolume, utils/mesh_utils.py:158-199, and filters
small clusters, post_process_mesh, mesh_utils.py:24-45).

* ``TsdfVolume`` is a dense [X,Y,Z] grid on the device;
  ``integrate_view`` updates it in place, one X-slab of voxels at a time
  (the update is elementwise, so the slabs change no value).  The
  voxel -> pixel projection keeps the JAX package's component order and
  its half-to-even rounding, so both packages pick the same pixels.  XLA
  contracts some of the JAX package's multiply-adds into fused ones, and
  differently from one compilation to the next, so the fused tsdf agrees
  to float32 rounding (a few ulps), not bit for bit.
* ``extract_mesh`` runs marching tetrahedra (6 tets per cube) over X-slabs
  of 8 cube planes.  Only the cubes whose corners are all observed and
  change sign are marched; their triangles are kept in (slab, cube, tet,
  triangle) order, each slab's buffer sized from its own count, and
  welded by the native library, so from one volume both packages give
  the same vertices and faces, numbered alike.
* ``largest_components`` is the native cluster filter.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..data.cameras import Camera
from ..utils.general import resolve_device


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor     # [X,Y,Z] truncated signed distance (init 1)
    weight: torch.Tensor   # [X,Y,Z] accumulation weight
    color: torch.Tensor    # [3,X,Y,Z] accumulated colour (channel-major)
    origin: torch.Tensor   # [3] world position of voxel (0,0,0)
    voxel: float           # voxel edge length
    sdf_trunc: float       # truncation distance


def make_volume(bounds_min, bounds_max, voxel: float = 0.004,
                sdf_trunc: float | None = None, device="cuda") -> TsdfVolume:
    dev = resolve_device(device)
    bmin = np.asarray(bounds_min, np.float32)
    bmax = np.asarray(bounds_max, np.float32)
    dims = tuple(int(d) for d in np.maximum(
        np.ceil((bmax - bmin) / voxel).astype(int) + 1, 2))
    if sdf_trunc is None:
        sdf_trunc = 5.0 * voxel
    f32 = dict(dtype=torch.float32, device=dev)
    return TsdfVolume(
        tsdf=torch.ones(dims, **f32), weight=torch.zeros(dims, **f32),
        color=torch.zeros((3,) + dims, **f32),
        origin=torch.as_tensor(bmin, **f32),
        voxel=float(voxel), sdf_trunc=float(sdf_trunc))


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (a float32
    product is exact in float64, and these sums stay within its 53 bits):
    XLA fuses the marching's last multiply-add so in the JAX package."""
    return (a.to(b.device, torch.float64) * b.double()
            + c.double()).to(torch.float32)


# voxels per X-slab of integrate_view's temporaries
SLAB_VOXELS = 1 << 23


@torch.no_grad()
def integrate_view(vol: TsdfVolume, depth: torch.Tensor, rgb: torch.Tensor,
                   cam: Camera, depth_trunc: float = 6.0) -> TsdfVolume:
    """Integrate one view (depth [H,W], rgb [H,W,3]) into ``vol`` in
    place, and return it.  Zero or invalid depth pixels add nothing (the
    reference's mask step zeroes depth)."""
    X, Y, Z = vol.tsdf.shape
    dev = vol.tsdf.device
    ar = lambda n, lo=0: torch.arange(lo, n, device=dev).to(torch.float32)
    # world coordinates per axis; broadcast, they are the JAX package's
    # per-voxel px, py, pz
    py = (vol.origin[1] + vol.voxel * ar(Y))[None, :, None]
    pz = (vol.origin[2] + vol.voxel * ar(Z))[None, None, :]
    R = cam.w2c[:3, :3]
    t = cam.w2c[:3, 3]
    depth_flat = depth.reshape(-1)
    rgb_flat = rgb.reshape(-1, 3)
    step = max(1, SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, step):
        x1 = min(X, x0 + step)
        px = (vol.origin[0] + vol.voxel * ar(x1, x0))[:, None, None]
        # world -> camera, component by component in the JAX order
        pcx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
        pcy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
        z = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
        u = pcx / z * cam.fx + cam.W / 2.0
        v = pcy / z * cam.fy + cam.H / 2.0
        ui = torch.clamp(torch.round(u - 0.5).to(torch.int64), 0, cam.W - 1)
        vi = torch.clamp(torch.round(v - 0.5).to(torch.int64), 0, cam.H - 1)
        in_img = (z > 0) & (u >= 0) & (u < cam.W) & (v >= 0) & (v < cam.H)
        pix = vi * cam.W + ui
        d = depth_flat[pix]
        valid = in_img & (d > 0) & (d < depth_trunc)
        sdf = d - z
        valid = valid & (sdf > -vol.sdf_trunc)
        tsdf_new = torch.clamp(sdf / vol.sdf_trunc, -1.0, 1.0)

        w_old = vol.weight[x0:x1]
        t_old = vol.tsdf[x0:x1]
        w_add = valid.to(torch.float32)
        w_new = w_old + w_add
        safe = torch.clamp_min(w_new, 1e-12)
        t_upd = (t_old * w_old + tsdf_new * w_add) / safe
        t_out = torch.where(valid, t_upd, t_old)
        for ch in range(3):
            c_old = vol.color[ch, x0:x1]
            c_px = rgb_flat[:, ch][pix]
            c_upd = (c_old * w_old + c_px * w_add) / safe
            c_old.copy_(torch.where(valid, c_upd, c_old))
        vol.tsdf[x0:x1] = t_out
        vol.weight[x0:x1] = w_new
    return vol


# ----------------------------------------------------------------------
# Marching tetrahedra
# ----------------------------------------------------------------------

# each cube splits into 6 tets over corners indexed 0..7 (binary xyz)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64)
_CORNER = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                    for z in (0, 1)], np.int64)  # corner i = bits xyz
# triangle emission per 4-bit tet sign case: up to 2 triangles, each
# vertex an edge (pair of tet-corner indices); -1 padding
_TET_TRIS = -np.ones((16, 2, 3, 2), np.int64)


def _set_case(case, tris):
    _TET_TRIS[case, :len(tris)] = np.asarray(tris, np.int64)


# bit i set <=> corner i inside (tsdf < 0); edges written so the winding
# is consistent (normal toward the outside)
_set_case(0b0001, [[(0, 1), (0, 2), (0, 3)]])
_set_case(0b1110, [[(0, 1), (0, 3), (0, 2)]])
_set_case(0b0010, [[(1, 0), (1, 3), (1, 2)]])
_set_case(0b1101, [[(1, 0), (1, 2), (1, 3)]])
_set_case(0b0100, [[(2, 0), (2, 1), (2, 3)]])
_set_case(0b1011, [[(2, 0), (2, 3), (2, 1)]])
_set_case(0b1000, [[(3, 0), (3, 2), (3, 1)]])
_set_case(0b0111, [[(3, 0), (3, 1), (3, 2)]])
_set_case(0b0011, [[(0, 2), (1, 3), (0, 3)], [(0, 2), (1, 2), (1, 3)]])
_set_case(0b1100, [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]])
_set_case(0b0101, [[(0, 1), (2, 3), (0, 3)], [(0, 1), (2, 1), (2, 3)]])
_set_case(0b1010, [[(0, 1), (0, 3), (2, 3)], [(0, 1), (2, 3), (2, 1)]])
_set_case(0b0110, [[(1, 0), (2, 3), (1, 3)], [(1, 0), (2, 0), (2, 3)]])
_set_case(0b1001, [[(1, 0), (1, 3), (2, 3)], [(1, 0), (2, 3), (2, 0)]])


def _march(tsdf: torch.Tensor, weight: torch.Tensor, origin: torch.Tensor,
           voxel: torch.Tensor) -> torch.Tensor:
    """Marching tetrahedra at iso 0 over one slab [nx+1, Y, Z].  Returns
    the triangles [F,3,3] in (cube, tet, triangle) order, cubes in
    row-major (x, y, z) order."""
    dev = tsdf.device
    nx, ny, nz = (s - 1 for s in tsdf.shape)
    corner = torch.as_tensor(_CORNER, device=dev)
    inside, seen = tsdf < 0.0, weight > 0
    sub = lambda a, c: a[c[0]:c[0] + nx, c[1]:c[1] + ny, c[2]:c[2] + nz]
    any_in = torch.zeros((nx, ny, nz), dtype=torch.bool, device=dev)
    all_in = torch.ones_like(any_in)
    observed = torch.ones_like(any_in)
    for c in _CORNER:
        any_in |= sub(inside, c)
        all_in &= sub(inside, c)
        observed &= sub(seen, c)
    # only a cube with corners on both sides can hold a triangle
    base = torch.nonzero(observed & any_in & ~all_in)          # [A,3]
    if base.shape[0] == 0:
        return torch.zeros((0, 3, 3), dtype=torch.float32, device=dev)
    corners = base[:, None, :] + corner[None]                  # [A,8,3]
    vals = tsdf[corners[..., 0], corners[..., 1], corners[..., 2]]
    tets = torch.as_tensor(_TETS, device=dev)
    tet_vals = vals[:, tets]                                   # [A,6,4]
    inside_t = (tet_vals < 0.0).to(torch.int64)
    case = (inside_t[..., 0] | (inside_t[..., 1] << 1)
            | (inside_t[..., 2] << 2) | (inside_t[..., 3] << 3))
    tris = torch.as_tensor(_TET_TRIS, device=dev)[case]        # [A,6,2,3,2]
    a, tet, k = torch.nonzero(tris[..., 0, 0] >= 0).unbind(-1)
    # each triangle vertex is an edge: two of the cube's corners
    ci = tets[tet[:, None, None], tris[a, tet, k]]             # [F,3,2]
    p = corners[a[:, None, None], ci].to(torch.float32)        # [F,3,2,3]
    v = vals[a[:, None, None], ci]                             # [F,3,2]
    v0, v1 = v[..., 0], v[..., 1]
    t = v0 / torch.where(torch.abs(v0 - v1) < 1e-12, 1e-12, v0 - v1)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    p0, p1 = p[..., 0, :], p[..., 1, :]
    verts = p0 + t * (p1 - p0)                                 # [F,3,3]
    return _fma(voxel, verts, origin[None, None, :])


@torch.no_grad()
def extract_mesh(vol: TsdfVolume, slab: int = 8):
    """-> (vertices [V,3] float32, faces [F,3] int32) on the host, the
    vertices welded (on a voxel/1024 grid) so connectivity filters work.
    The volume is marched in X-slabs of ``slab`` cube planes."""
    from ..native import weld_mesh
    X = vol.tsdf.shape[0]
    # the voxel edge in float32, as the JAX package holds it once its
    # integrate_view has run: the slab origins and the weld cell follow
    vox = torch.tensor(vol.voxel, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    tris = []
    for x0 in range(0, max(X - 1, 1), slab):
        x1 = min(X, x0 + slab + 1)
        o = vol.origin + torch.stack([x0 * vox, zero, zero]).to(
            vol.origin.device)
        tri = _march(vol.tsdf[x0:x1], vol.weight[x0:x1], o, vox)
        if tri.shape[0]:
            tris.append(tri.cpu().numpy())
    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return weld_mesh(np.concatenate(tris, axis=0), float(vox / 1024.0))


@torch.no_grad()
def sample_colors(vol: TsdfVolume, verts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the fused colour volume at vertex positions
    (Open3D's extract_triangle_mesh bakes vertex colours the same way)."""
    g = (verts - vol.origin[None, :]) / vol.voxel
    X, Y, Z = vol.tsdf.shape
    g0 = torch.floor(g).to(torch.int64)
    f = g - g0
    acc = torch.zeros((verts.shape[0], 3), dtype=torch.float32,
                      device=verts.device)
    wacc = torch.zeros((verts.shape[0], 1), dtype=torch.float32,
                       device=verts.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ii = torch.clamp(g0[:, 0] + dx, 0, X - 1)
                jj = torch.clamp(g0[:, 1] + dy, 0, Y - 1)
                kk = torch.clamp(g0[:, 2] + dz, 0, Z - 1)
                w = (torch.abs(1 - dx - f[:, 0]) * torch.abs(1 - dy - f[:, 1])
                     * torch.abs(1 - dz - f[:, 2]))
                w = w * (vol.weight[ii, jj, kk] > 0)
                acc = acc + w[:, None] * vol.color[:, ii, jj, kk].T
                wacc = wacc + w[:, None]
    return acc / torch.clamp_min(wacc, 1e-8)


def largest_components(verts: np.ndarray, faces: np.ndarray,
                       keep: int = 1, min_ratio: float = 0.0):
    """Keep the `keep` largest connected components by triangle count
    (post_process_mesh, mesh_utils.py:24-45), with the native library's
    union-find (d2dgs_torch.native)."""
    from ..native import filter_components
    if faces.shape[0] == 0:
        return verts, faces
    return filter_components(verts, faces, keep=keep, min_ratio=min_ratio)


def load_mesh_ply(path: str):
    """Read a triangle-mesh PLY written by ``save_mesh_ply`` (binary
    little-endian, optional uchar colours).  Returns (verts [V,3] f32,
    faces [F,3] i32)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")
                     ).split()[-1])
        f = int(next(h for h in header if h.startswith("element face")
                     ).split()[-1])
        has_c = any("uchar red" in h for h in header)
        vt = (np.dtype([("p", "<f4", 3), ("c", "u1", 3)]) if has_c
              else np.dtype([("p", "<f4", 3)]))
        va = np.frombuffer(fh.read(n * vt.itemsize), vt)
        ft = np.dtype([("k", "u1"), ("i", "<i4", 3)])
        fa = np.frombuffer(fh.read(f * ft.itemsize), ft)
    return va["p"].astype(np.float32), fa["i"].astype(np.int32)


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                  colors: np.ndarray | None = None) -> None:
    """Binary little-endian triangle-mesh PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, f = verts.shape[0], faces.shape[0]
    has_c = colors is not None
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if has_c:
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    lines += [f"element face {f}",
              "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(lines) + "\n").encode("ascii"))
        if has_c:
            c8 = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            vt = np.dtype([("p", "<f4", 3), ("c", "u1", 3)])
            arr = np.empty(n, vt)
            arr["p"] = verts.astype("<f4")
            arr["c"] = c8
            fh.write(arr.tobytes())
        else:
            fh.write(verts.astype("<f4").tobytes())
        ft = np.dtype([("k", "u1"), ("v", "<i4", 3)])
        farr = np.empty(f, ft)
        farr["k"] = 3
        farr["v"] = faces.astype("<i4")
        fh.write(farr.tobytes())
