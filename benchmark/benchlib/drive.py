"""The two kinds of traffic, each run by one general function from its
traffic file's parameters: ``train`` (the Trainer resumed mid-run,
stepped) and ``serve`` (one closed-loop client asking for views).

A run: set-up (inputs from the seed, the port's model, the warm-up that
the traffic's own calls make), the measured window of ``seconds``, with
``trace`` a traced segment after it, then the port's state freed and the
plain reference's comparison of what the window's path produced.
"""
from __future__ import annotations

import gc
import math
import random
import sys
import time

import numpy as np
import torch

from . import compare, program, reference, scene, tracing


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _free(device) -> None:
    gc.collect()
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _to_cpu(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}


def sampler_picks(seed: int, n_views: int, count: int) -> list:
    """The cameras the Trainer's sampler picks first, worked out from its
    seed as ``Trainer._pick_camera`` draws them: a pass over every view
    in the order of ``RandomState(seed).randint`` pops."""
    rng, stack, out = np.random.RandomState(seed), [], []
    for _ in range(count):
        if not stack:
            stack = list(range(n_views))
        out.append(stack.pop(rng.randint(len(stack))))
    return out


def walk_counts(state: dict, cfg: dict, cams: list) -> dict:
    """The plain walk's work on ``cams``, averaged per view."""
    acc = None
    for cam in cams:
        _, w = reference.view_uint8(state, cfg, cam, want_walk=True)
        acc = w if acc is None else {k: acc[k] + w[k] for k in acc}
    return {k: v / len(cams) for k, v in acc.items()}


def run_train(cell: dict, seed: int, seconds: float, trace: bool, device,
              t_start: float) -> dict:
    cfg, tf = cell["config"], cell["traffic"]
    pool = scene.view_pool(tf, device)
    H, W = tf["height"], tf["width"]
    sampler_seed, n_cmp = tf["sampler_seed"], tf["compared_steps"]
    picks = sampler_picks(sampler_seed, len(pool), n_cmp)
    base = scene.make_state(cfg, seed, device)
    # the targets of the steps the reference follows, rendered by the
    # reference from the unperturbed scene: not set-up's time, and freed
    # before the port runs
    t_ref = time.perf_counter()
    gts = reference.targets(base, cfg, [pool[i] for i in picks])
    _free(device)
    _reset_peak(device)
    ref_s = time.perf_counter() - t_ref
    images = [torch.empty((H, W, 3), device=device) for _ in pool]
    tr = program.make_trainer(cfg, pool, images, base,
                              tf["start_iteration"], sampler_seed, device)
    program.render_targets(tr, pool, images, skip=set(picks))
    for i, gt in zip(picks, gts):
        images[i].copy_(gt)
    start = scene.perturbed(base, seed, tf["perturb"], device)
    del base
    program.load_state(tr.state.gauss, tr.state.nodes, start)
    start = scene.copy_state(start, "cpu")
    l1s, g1, p_cmp = [], None, None
    for k in range(tf["warm_steps"]):
        m = tr.step()
        if k < n_cmp:
            l1s.append(float(m["loss"]))
        if k == 0:
            g1 = {n: v / (1.0 - 0.9)
                  for n, v in _to_cpu(program.first_moments(tr)).items()}
        if k == n_cmp - 1:
            p_cmp = _to_cpu(program.leaves(tr))
    _sync(device)
    setup_s = time.time() - t_start - ref_s

    t0, steps = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        tr.step()
        steps += 1
    _sync(device)
    window = time.perf_counter() - t0
    peak = _peak(device)
    out = dict(kind="train", attempted=steps, failed=0, peak=peak,
               e2e={"train_step_ms": window / steps * 1e3,
                    "setup_s": setup_s})
    if trace:
        snap = program.snapshot(tr)
        k1a, k2a = program.blend_launches()
        out["trace"] = tracing.traced(tr.step, tf["trace_units"], device)
        k1b, k2b = program.blend_launches()
        out["counters"] = {"k1_launches": k1b - k1a,
                           "k2_launches": k2b - k2a}
    del tr, images
    _free(device)
    t_ref = time.perf_counter()

    # the plain reference: the first three steps from the same start
    p0 = _to_cpu(reference.leaves(start))
    ref = reference.follow(scene.copy_state(start, device), cfg,
                           [pool[i] for i in picks], gts,
                           tf["start_iteration"])
    _free(device)
    numbers = compare.train_numbers(
        {"l1": l1s, "g1": g1, "delta": {k: p_cmp[k] - p0[k] for k in p0}},
        ref)
    out["numbers"] = numbers
    log(f"setup {setup_s:.2f} s, window {window:.2f} s ({steps} steps), "
        f"reference {time.perf_counter() - t_ref + ref_s:.2f} s "
        f"({ref_s:.2f} s of it the targets, before set-up's end)")
    if trace:
        # the traced steps' own views: the sampler's picks after the warm
        # and window steps
        n = tf["warm_steps"] + steps + tf["trace_units"]
        cams = [pool[i] for i in sampler_picks(sampler_seed, len(pool), n)
                [-tf["trace_units"]:]]
        out["walk"] = walk_counts(snap, cfg, cams)
        out["n_live"] = int(snap["gauss"]["alive"].sum())
        out["unit_s"] = window / steps
    return out


def run_serve(cell: dict, seed: int, seconds: float, trace: bool, device,
              t_start: float) -> dict:
    cfg, tf = cell["config"], cell["traffic"]
    s = scene.seeds(seed)
    state = scene.make_state(cfg, seed, device)
    view = program.make_viewer(cfg, state, device)
    pool = scene.view_pool(tf, device)
    order = np.random.RandomState(tf["order_seed"]).permutation(len(pool))

    def serve(i: int):
        img = view(pool[order[i % len(pool)]])
        return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8).cpu()

    for i in range(tf["warm_views"]):
        serve(i)
    _sync(device)
    setup_s = time.time() - t_start

    rng, k = random.Random(s["sample"]), tf["sample_views"]
    sample, lat = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t_req = time.perf_counter()
        img8 = serve(len(lat))
        lat.append(time.perf_counter() - t_req)
        i = len(lat) - 1
        if len(sample) < k:
            sample.append((i, img8))
        else:
            j = rng.randint(0, i)
            if j < k:
                sample[j] = (i, img8)
    window = time.perf_counter() - t0
    peak = _peak(device)
    lat.sort()
    p95 = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
    out = dict(kind="serve", attempted=len(lat), failed=0, peak=peak,
               e2e={"view_ms": window / len(lat) * 1e3,
                    "view_ms_p95": p95 * 1e3, "setup_s": setup_s})
    if trace:
        # the traced views: the compared sample's, in turn, so that the
        # walk the reference counts on them is the traced views' work
        k1a, _ = program.blend_launches()
        turn = iter([i for i, _ in sample] * tf["trace_units"])
        out["trace"] = tracing.traced(lambda: serve(next(turn)),
                                      tf["trace_units"], device)
        out["counters"] = {"k1_launches": program.blend_launches()[0] - k1a}
    del view
    _free(device)
    t_ref = time.perf_counter()

    pairs, walks = [], []
    for i, img8 in sample:
        ref8, w = reference.view_uint8(state, cfg, pool[order[i % len(pool)]],
                                       want_walk=trace)
        pairs.append((img8, ref8))
        walks.append(w)
    out["numbers"] = compare.serve_numbers(pairs)
    log(f"setup {setup_s:.2f} s, window {window:.2f} s ({len(lat)} views), "
        f"reference {time.perf_counter() - t_ref:.2f} s")
    if trace:
        out["walk"] = {k: sum(w[k] for w in walks) / len(walks)
                       for k in walks[0]}
        out["n_live"] = int(state["gauss"]["alive"].sum())
        out["unit_s"] = window / len(lat)
    return out


RUNNERS = {"train": run_train, "serve": run_serve}
