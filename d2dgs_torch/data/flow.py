"""RAFT optical-flow supervision files (counterpart of
d2dgs_tpu/data/flow.py, the reference's scene/__init__.py:82-87 and
train_gui.py:318-339).

A scene may hold ``raft_neighbouring/<image stem>.<...>.npy`` flow fields
(pixel displacements toward a neighbouring frame, whose name ends the
file name) with companion ``raft_masks/<...>.png`` masks (channel 0
cycle consistency, channel 1 occlusion), written offline by a RAFT
runner.  This module finds and loads them, as numpy arrays.

As in the JAX package, a flow file at another resolution than the
images has its values scaled by (W/w, H/h) when it is resized.
"""
from __future__ import annotations

import os

import numpy as np


def find_flow_dirs(source_path: str, samples) -> list[list[str]]:
    """Per-sample candidate flow files: ``raft_neighbouring/<stem>.*``."""
    flow_dir = os.path.join(source_path, "raft_neighbouring")
    if not os.path.isdir(flow_dir):
        return [[] for _ in samples]
    flow_list = os.listdir(flow_dir)
    out = []
    for s in samples:
        stem = os.path.splitext(s.image_name)[0]
        out.append([os.path.join(flow_dir, f) for f in flow_list
                    if f.startswith(stem + ".")])
    return out


def target_name(flow_path: str) -> str:
    """Frame name the flow points at (train_gui.py:332): the file name
    after its last underscore, up to the first dot."""
    return os.path.basename(flow_path).split("_")[-1].split(".")[0]


def load_flow(flow_path: str, H: int, W: int):
    """Returns (flow [H,W,2] float32 in units of [W, H] / 2, mask [H,W,1]
    float32), as numpy.

    The flow is divided by the image size and doubled, as the reference
    (train_gui.py:339); the mask is (cycle consistency | occlusion), all
    ones without a mask file.  Files at another resolution are resized
    to (H, W): the flow bilinearly, its values scaled by the size ratio,
    the masks by nearest neighbour."""
    from PIL import Image
    flow = np.load(flow_path).astype(np.float32)           # [h,w,2]
    mask_path = flow_path.replace("raft_neighbouring", "raft_masks") \
        .replace(".npy", ".png")
    if os.path.exists(mask_path):
        masks = np.asarray(Image.open(mask_path), np.float32) / 255.0
    else:
        masks = np.ones(flow.shape[:2] + (2,), np.float32)
    if flow.shape[0] != H or flow.shape[1] != W:
        sy, sx = H / flow.shape[0], W / flow.shape[1]
        fi = Image.fromarray(flow[..., 0]).resize((W, H), Image.BILINEAR)
        fj = Image.fromarray(flow[..., 1]).resize((W, H), Image.BILINEAR)
        flow = np.stack([np.asarray(fi) * sx, np.asarray(fj) * sy], -1)
        mi = Image.fromarray((masks[..., 0] * 255).astype(np.uint8)) \
            .resize((W, H), Image.NEAREST)
        mo = Image.fromarray((masks[..., 1] * 255).astype(np.uint8)) \
            .resize((W, H), Image.NEAREST)
        masks = np.stack([np.asarray(mi), np.asarray(mo)], -1) / 255.0
    flow_norm = flow / np.array([W, H], np.float32) * 2.0
    mask = ((masks[..., 0] > 0) | (masks[..., 1] > 0)).astype(np.float32)
    return flow_norm, mask[..., None]
