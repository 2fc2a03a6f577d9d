"""RAFT optical-flow file discovery (counterpart of d2dgs_tpu/data/flow.py,
the reference's scene/__init__.py:82-87).

Only ``find_flow_dirs`` is ported: ``cli train`` uses it to refuse a
scene with flow files, since the optical-flow loss is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import os


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
