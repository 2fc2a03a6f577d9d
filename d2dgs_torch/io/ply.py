"""Reference-compatible Gaussian PLY io (counterpart of d2dgs_tpu/io/ply.py,
the reference's gaussian_model.py:229-307).

Binary little-endian PLY written and read with numpy (no plyfile).  The
field layout is the reference's: x,y,z, nx,ny,nz, f_dc_0..2,
f_rest_0..(3*((d+1)^2-1)-1), opacity, scale_0..1, rot_0..3
[, fea_0..fea_dim-1]; f_dc/f_rest are channel-major (torch's
``.transpose(1, 2).flatten(1)``).  Only alive rows are written, so both
packages write the same bytes for the same state.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.gaussians import GaussianParams
from ..utils.general import resolve_device


def _header(names: list[str], count: int) -> bytes:
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {count}"]
    lines += [f"property float {n}" for n in names]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def save_gaussian_ply(path: str, params: GaussianParams) -> None:
    """Write the alive rows of ``params``."""
    host = lambda t: t.detach().cpu().numpy().astype(np.float32)
    alive = params.alive.cpu().numpy()
    xyz = host(params.xyz)[alive]
    n = xyz.shape[0]
    f_dc = host(params.features_dc)[alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = host(params.features_rest)[alive].transpose(0, 2, 1) \
        .reshape(n, -1)
    opac = host(params.opacity)[alive].reshape(n, -1)
    scale = host(params.scaling)[alive]
    rot = host(params.rotation)[alive]

    cols = [xyz, np.zeros_like(xyz), f_dc, f_rest, opac, scale, rot]
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scale.shape[1])]
             + [f"rot_{i}" for i in range(rot.shape[1])])
    fea = host(params.feature)[alive]
    if fea.shape[1] > 0:
        cols.append(fea)
        names += [f"fea_{i}" for i in range(fea.shape[1])]

    data = np.concatenate(cols, axis=1).astype("<f4")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(names, n))
        f.write(np.ascontiguousarray(data).tobytes())


def _read_ply(path: str):
    with open(path, "rb") as f:
        names, count = [], 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                count = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                if typ not in ("float", "float32"):
                    raise ValueError(f"{path}: unsupported property type "
                                     f"{typ!r}")
                names.append(name)
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(count * len(names) * 4),
                             dtype="<f4").reshape(count, len(names))
    return dict(zip(names, data.T)), count


def load_gaussian_ply(path: str, capacity: int, sh_degree: int,
                      fea_dim: int = 0, with_motion_mask: bool = False,
                      device="cuda") -> GaussianParams:
    """Read a (reference or ours) Gaussian PLY into GaussianParams padded
    to ``capacity`` (gaussian_model.py:256-307)."""
    dev = resolve_device(device)
    fields, n = _read_ply(path)
    if n > capacity:
        raise ValueError(f"{n} gaussians > capacity {capacity}")

    def grab(prefix, width):
        ks = sorted((k for k in fields if k.startswith(prefix)),
                    key=lambda s: int(s[len(prefix):]))
        if len(ks) != width:
            raise ValueError(f"{path}: {len(ks)} {prefix}* fields, "
                             f"expected {width}")
        return np.stack([fields[k] for k in ks], axis=1)

    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1)
    rest_w = 3 * ((sh_degree + 1) ** 2 - 1)
    f_dc = grab("f_dc_", 3).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = grab("f_rest_", rest_w).reshape(n, 3, rest_w // 3)
    f_rest = f_rest.transpose(0, 2, 1)
    opac = fields["opacity"].reshape(n, 1)
    scale = grab("scale_", 2)
    rot = grab("rot_", 4)
    tot_fea = fea_dim + (1 if with_motion_mask else 0)
    if tot_fea > 0 and any(k.startswith("fea_") for k in fields):
        fea = grab("fea_", tot_fea)
    else:
        fea = np.zeros((n, tot_fea), np.float32)

    def pad(a):
        out = np.zeros((capacity,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    alive = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    alive[:n] = True
    return GaussianParams(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(f_rest),
        scaling=pad(scale), rotation=pad(rot), opacity=pad(opac),
        feature=pad(fea), alive=alive, active_sh_degree=sh_degree,
        with_motion_mask=with_motion_mask)
