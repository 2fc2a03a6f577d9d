"""The port's spans and counters (``d2dgs_torch.trace``) on a tiny
main-stage step and a tiny served view: off without a profiler, the span
tree and the counters under one, the same results either way, and the
benchmark's readers of the report.  This file imports torch and
d2dgs_torch only, so it also runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_trace.py -q --noconftest -o addopts=""

The test marked ``cuda`` skips where torch.cuda.is_available() is False."""
import dataclasses
import functools
import sys
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.synthetic import make_video_dataset
from d2dgs_torch.eval.render_sets import render_view
from d2dgs_torch.models import deform
from d2dgs_torch.train.trainer import (Trainer, gauss_trainable,
                                       mlp_trainable, node_trainable)
from torch_tiny import TINY

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from benchlib import spans  # noqa: E402

# one intra-op thread, as the other trainer tests: the suite's worker
# processes would contend for the cores
torch.set_num_threads(1)

STEP = ("d2dgs.pick", "d2dgs.field", "d2dgs.project", "d2dgs.bin",
        "d2dgs.blend", "d2dgs.loss", "d2dgs.loss", "d2dgs.backward",
        "d2dgs.adam", "d2dgs.adam")
VIEW = ("d2dgs.field", "d2dgs.project", "d2dgs.bin", "d2dgs.blend")


@pytest.fixture(autouse=True)
def _empty_record():
    trace.reset()
    yield
    trace.reset()


@functools.lru_cache(maxsize=None)
def _video(device):
    return make_video_dataset(3, n_cams=2, n_times=2, H=32, W=32,
                              n_gauss=16, device=device)


def _trainer(device="cpu", cfg=TINY):
    """TINY's Trainer on a 32x32 synthetic video, at its main stage as a
    resumed run stands."""
    cams, imgs, pts, cols = _video(device)
    tr = Trainer(cfg, cams, imgs, pts, cols, cameras_extent=4.0, seed=0,
                 device=device)
    tr.iteration_node = cfg.iterations_node_rendering
    return tr


def _view(tr):
    st, cam = tr.state, tr.cameras[1]
    return render_view(cam, st.gauss, st.nodes, tr.cfg.deform_cfg,
                       tr.cfg.raster, torch.zeros(3, device=cam.device))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _leaves(tr) -> dict:
    st = tr.state
    return {f"{g}.{k}": v.detach().clone() for g, d in (
        ("gauss", gauss_trainable(st.gauss)), ("mlp", mlp_trainable(st.nodes)),
        ("nodes", node_trainable(st.nodes))) for k, v in d.items()}


def test_off_without_a_profiler():
    """No profiler: every span is the one shared no-op, and a step and a
    view record nothing."""
    assert not trace.enabled()
    assert trace.span("d2dgs.a") is trace.span("d2dgs.b")
    tr = _trainer()
    tr.step()
    _view(tr)
    trace.count("host.reads", 1)
    assert trace.records() == []
    assert trace.report() == {"units": 0, "spans": {}, "counters": {}}


def test_span_tree_of_a_step_and_a_view():
    """Under a CPU profiler: one root per step or view, its unit shared
    by its children, each child's parent the root, the layers in order;
    self time within the span's time; no stream time on the CPU."""
    tr = _trainer()

    def run():
        tr.step()
        tr.step()
        _view(tr)
        assert trace.enabled()
    _traced(run)
    recs = trace.records()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["d2dgs.step", "d2dgs.step",
                                             "d2dgs.view"]
    assert len({recs[i].unit for i in roots}) == 3
    for i, want in zip(roots, (STEP, STEP, VIEW)):
        kids = [r for r in recs if r.parent == i]
        assert tuple(r.name for r in kids) == want
        assert all(r.unit == recs[i].unit for r in kids)
        assert all(recs[i].start_ns <= r.start_ns <= r.end_ns
                   <= recs[i].end_ns for r in kids)
    # the node MLP at the nodes, the spans' only grandchildren: one
    # d2dgs.mlp inside each d2dgs.field, and one inside a step's ARAP
    # term (d2dgs.loss), which queries it again
    mlps = [r for r in recs if r.name == "d2dgs.mlp"]
    assert [recs[r.parent].name for r in mlps] == [
        "d2dgs.field", "d2dgs.loss", "d2dgs.field", "d2dgs.loss",
        "d2dgs.field"]
    assert all(r.unit == recs[r.parent].unit for r in mlps)
    assert len(recs) == len(roots) + 2 * len(STEP) + len(VIEW) + len(mlps)
    rep = trace.report()
    assert rep["units"] == 3
    for name, s in rep["spans"].items():
        assert 0.0 <= s["host_self_ms"] <= s["host_ms"], name
        assert s["stream_ms"] is None, name
    assert rep["spans"]["d2dgs.loss"]["count"] == 4
    assert rep["spans"]["d2dgs.field"]["parents"] == ["d2dgs.step",
                                                      "d2dgs.view"]
    assert rep["spans"]["d2dgs.step"]["parents"] == []


def test_counters_on_a_tiny_scene():
    """field.rows counts the rows each field call evaluates, the live
    ones (the step and the view pass the mask), render.live the live
    surfels each render draws, field.row_lists the one live-row list
    the step built and the view reused."""
    tr = _trainer()
    cap, live = TINY.gaussian_capacity, int(tr.state.gauss.alive.sum())
    assert 0 < live < cap
    _traced(lambda: (tr.step(), _view(tr)))
    c = trace.report()["counters"]
    assert c["field.rows"] == 2 * live
    assert c["render.live"] == 2 * live
    assert c["field.row_lists"] == 1
    assert c["host.reads"] > 0


def test_hexplane_span_and_counter_of_a_step_and_a_view():
    """The hexplane field: one d2dgs.hexplane inside each d2dgs.field, the
    planes' regulariser a second d2dgs.loss of a step (where the node
    field's ARAP term is), field.plane_samples 12 a row the field
    evaluated; the docstring of trace.py names both."""
    tr = _trainer(cfg=dataclasses.replace(TINY, deform_type="hexplane"))
    _traced(lambda: (tr.step(), _view(tr)))
    recs = trace.records()
    hexes = [r for r in recs if r.name == "d2dgs.hexplane"]
    assert [recs[r.parent].name for r in hexes] == ["d2dgs.field"] * 2
    step = [r.name for r in recs if r.parent == 0]
    assert step[step.index("d2dgs.loss"):step.index("d2dgs.backward")] == \
        ["d2dgs.loss", "d2dgs.loss"]
    c = trace.report()["counters"]
    assert c["field.plane_samples"] == 12 * c["field.rows"] > 0
    for name in ("d2dgs.hexplane", "field.plane_samples"):
        assert f"``{name}``" in trace.__doc__, name


def test_adam_counters_of_a_step():
    """adam.leaves counts the leaves of a step's three groups,
    adam.kernel_leaves those the Adam kernel updated: none on the CPU."""
    tr = _trainer()
    _traced(tr.step)
    c = trace.report()["counters"]
    assert c["adam.leaves"] == len(_leaves(tr)) > 0
    assert c["adam.kernel_leaves"] == 0


def test_tracing_changes_no_result():
    """The loss, every updated leaf and the image, bitwise, with tracing
    on and off, from two identical trainers."""
    off, on = _trainer(), _trainer()
    m_off = off.step()
    m_on = _traced(on.step)
    assert torch.equal(m_off["loss"], m_on["loss"])
    a, b = _leaves(off), _leaves(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(_view(off).image, _traced(lambda: _view(on)).image)


def test_readers_of_a_report(monkeypatch):
    """The benchmark's readers: stream time per unit, the live share and
    the reads per unit; None where the units differ from the traced
    segment's, without stream times, or without a trace."""
    span = lambda ms: dict(count=2, host_ms=9.0, host_self_ms=8.0,
                           stream_ms=ms, parents=["d2dgs.step"])
    rep = {"units": 2,
           "spans": {"d2dgs.field": span(12.0), "d2dgs.project": span(1.0),
                     "d2dgs.bin": span(3.0), "d2dgs.blend": span(5.0),
                     "d2dgs.loss": span(2.0), "d2dgs.backward": span(80.0),
                     "d2dgs.adam": span(6.0)},
           "counters": {"field.rows": 400_000, "render.live": 166_504,
                        "host.reads": 30}}
    ctx = {"trace": {"units": 2}, "spans": rep}
    assert spans.field_ms(ctx) == 6.0
    assert spans.bin_ms(ctx) == 2.0
    assert spans.blend_ms(ctx) == 2.5
    assert spans.loss_ms(ctx) == 1.0
    assert spans.backward_ms(ctx) == 40.0
    assert spans.adam_ms(ctx) == 3.0
    assert spans.field_live_share(ctx) == pytest.approx(41.626)
    assert spans.host_reads_per_unit(ctx) == 15.0
    readers = (spans.field_ms, spans.bin_ms, spans.blend_ms, spans.loss_ms,
               spans.backward_ms, spans.adam_ms, spans.field_live_share,
               spans.host_reads_per_unit)
    for read in readers:
        assert read({"trace": {"units": 3}, "spans": rep}) is None
        assert read({"spans": rep}) is None
    cpu = dict(rep, spans={k: span(None) for k in rep["spans"]})
    assert spans.field_ms({"trace": {"units": 2}, "spans": cpu}) is None
    # without a report in the run, the port's own is read, once
    tr = _trainer()
    _traced(lambda: _view(tr))
    ctx = {"trace": {"units": 1}}
    # the view evaluates the field at the live rows only
    live = int(tr.state.gauss.alive.sum())
    assert 0 < live < TINY.gaussian_capacity
    assert spans.field_live_share(ctx) == pytest.approx(100.0)
    assert ctx["spans"]["units"] == 1
    trace.reset()
    assert spans.host_reads_per_unit(ctx) == ctx["spans"]["counters"][
        "host.reads"]
    # a field over every slot: the live ones over the capacity
    monkeypatch.setattr(deform, "live_rows", lambda alive: None)
    _traced(lambda: _view(tr))
    ctx = {"trace": {"units": 1}}
    assert spans.field_live_share(ctx) == pytest.approx(
        100.0 * live / TINY.gaussian_capacity)


def test_adam_kernel_share_reader():
    """benchmark/metrics/adam_kernel_share.train.py: the kernel's leaves
    over Adam's (%), None where the port's report lacks the counters (a
    program without them) or there is no report."""
    from benchlib import cells
    read = cells.reader(Path(spans.__file__).resolve().parents[1]
                        / "metrics", "adam_kernel_share.train")
    counters = {"host.reads": 18, "adam.leaves": 114,
                "adam.kernel_leaves": 114}
    rep = {"units": 3, "spans": {}, "counters": counters}
    assert read({"trace": {"units": 3}, "spans": rep}) == 100.0
    half = dict(rep, counters=dict(counters, **{"adam.kernel_leaves": 57}))
    assert read({"trace": {"units": 3}, "spans": half}) == 50.0
    parent = dict(rep, counters={"host.reads": 36})
    assert read({"trace": {"units": 3}, "spans": parent}) is None
    assert read({"trace": {"units": 2}, "spans": rep}) is None
    assert read({"spans": rep}) is None


@pytest.mark.cuda
def test_host_reads_count_every_sync():
    """On the card: under a profiler and torch's sync debug mode, the
    synchronising calls of a step and a view (K1/K2's route) are as many
    as the host.reads counter says, the live-row list's rebuild after a
    write to the mask included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    cfg = dataclasses.replace(TINY, raster=RasterConfig(tile_cap=256))
    tr = _trainer("cuda", cfg)
    tr.step()
    _view(tr)
    torch.cuda.synchronize()
    trace.reset()
    alive = tr.state.gauss.alive
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            alive.copy_(alive.clone())     # a write: the list is rebuilt
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tr.step()
                _view(tr)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in got
             if "called a synchronizing CUDA operation" in str(w.message)]
    rep = trace.report()
    assert rep["units"] == 2
    assert rep["counters"]["field.row_lists"] == 1
    assert len(syncs) == rep["counters"]["host.reads"] > 0, syncs
