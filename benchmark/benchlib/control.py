"""The control of the comparison: the plain reference put in the port's
place and computed one precision below the configuration's (TF32 for
float32 with TF32 off), judged by the same numbers against the float32
reference.  The benchmark's own runs never run it; ``readings.py`` and
the card's tests do, at the cell's own size."""
from __future__ import annotations

import random

from . import compare, reference, scene
from .drive import _free, sampler_picks


def train_numbers(cell: dict, seed: int, device,
                  variant: str = "tf32") -> dict:
    """The first three steps of the float32 reference and of the
    reference put in the port's place, from the cell's start, on the
    views the Trainer's sampler picks first (their targets rendered by
    the reference from the unperturbed scene, as a run renders them).
    ``variant``: "tf32" (the control), "half" (the fault of half the
    batch left out: the image losses over its upper half) or "self"
    (float32 again)."""
    cfg, tf = cell["config"], cell["traffic"]
    pool = scene.view_pool(tf, device)
    cams = [pool[i] for i in sampler_picks(tf["sampler_seed"], len(pool),
                                           tf["compared_steps"])]
    base = scene.make_state(cfg, seed, device)
    gts = reference.targets(base, cfg, cams)
    start = scene.copy_state(scene.perturbed(base, seed, tf["perturb"],
                                             device), "cpu")
    del base
    runs = []
    for low in (False, True):
        rows = slice(0, tf["height"] // 2) if low and variant == "half" \
            else slice(None)
        with reference.precision(low and variant == "tf32"):
            runs.append(reference.follow(scene.copy_state(start, device),
                                         cfg, cams, gts,
                                         tf["start_iteration"], rows))
        _free(device)
    return compare.train_numbers(runs[1], runs[0])


def serve_numbers(cell: dict, seed: int, device,
                  variant: str = "tf32") -> dict:
    """``sample_views`` views of the pool drawn from the seed, served by
    the reference in TF32 (``variant`` "tf32") or float32 ("self") and
    judged against the float32 one."""
    cfg, tf = cell["config"], cell["traffic"]
    s = scene.seeds(seed)
    state = scene.make_state(cfg, seed, device)
    pool = scene.view_pool(tf, device)
    idx = random.Random(s["sample"]).sample(range(len(pool)),
                                            tf["sample_views"])
    pairs = []
    for i in idx:
        ref8, _ = reference.view_uint8(state, cfg, pool[i])
        with reference.precision(variant == "tf32"):
            low8, _ = reference.view_uint8(state, cfg, pool[i])
        pairs.append((low8.cpu(), ref8))
    return compare.serve_numbers(pairs)


NUMBERS = {"train": train_numbers, "serve": serve_numbers}
