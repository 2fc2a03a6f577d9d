"""OBJ ground-truth mesh loading (counterpart of d2dgs_tpu/mesh/obj.py,
the reference's read_gt_mesh.py:1-78).

Plain-numpy parsers for the DG-Mesh ground-truth meshes: ``load_obj``
returns (verts [V,3], faces [F,3]); ``load_obj_mtl`` also reads the Kd
diffuse colour from a companion MTL file (one constant colour, expanded
per face vertex as the reference does).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def load_obj(obj_file: str):
    verts, faces = [], []
    with open(obj_file) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                face = [int(tok.split("/")[0]) - 1
                        for tok in line.split()[1:4]]
                faces.append(face)
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_obj_mtl(obj_file: str, mtl_file: str):
    verts, faces = load_obj(obj_file)
    materials = defaultdict(lambda: {"Kd": [1.0, 1.0, 1.0]})
    current = None
    with open(mtl_file) as f:
        for line in f:
            if line.startswith("newmtl "):
                current = line.split()[1]
            elif line.startswith("Kd "):
                materials[current]["Kd"] = [float(x)
                                            for x in line.split()[1:4]]
    kd = np.asarray(materials[current]["Kd"], np.float32)
    vertex_colors = np.tile(kd[None], (faces.shape[0] * 3, 1))
    return verts, faces, vertex_colors
