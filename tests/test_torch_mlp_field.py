"""The per-surfel MLP field (``deform_type`` "mlp", Deformable 3D
Gaussians' DeformNetwork with the Blender timenet) at its published
widths against the benchmark's plain reference
(``benchmark/benchlib/fields/mlp.py``), its span and counter, the
benchmark's readers of them, and tiny CPU runs of the cells
``mlp-train`` and ``hash-serve``.  This file imports torch, d2dgs_torch
and the benchmark's ``benchlib`` only:

    python -m pytest tests/test_torch_mlp_field.py -q
"""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.models import deform_mlp
from d2dgs_torch.models.deform import (apply_deform_field, deform_gaussians,
                                       init_deform)
from d2dgs_torch.train.config import TrainConfig

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH), str(BENCH / "tests")]
from benchlib import cells, counts, scene  # noqa: E402
from benchlib.fields import mlp as ref_mlp  # noqa: E402
# the harness's tiny cut (48x48 views, capacity 512) and its 300-surfel
# scene, shared so that the two stay one
from test_bench_harness import run_tiny, tiny_cell, tiny_scene  # noqa: E402,F401

torch.set_num_threads(1)

BENCHJ = cells.load_benchmark()
CFG = cells.cell(BENCHJ, "mlp-train")["config"]
# the cells' field: the mlp type of the benchmark's TrainConfig, whose
# deform_cfg turns the local frame off for it
DEFORM = TrainConfig(deform_type="mlp", is_blender=True).deform_cfg
# 2 * (13*256 + 256*30 + 93*256 + 4*256*256 + 349*256 + 2*256*256
#      + 256*(3 + 2 + 4)): the timenet, the trunk with its skip, the heads
OPS_PER_ROW = 2 * 519_680


@pytest.fixture(autouse=True)
def _empty_record():
    trace.reset()
    yield
    trace.reset()


def _state(path, seed=2 ** 31 + 77):
    """The benchmark's scene at capacity 320 (20 dead slots) with the
    field's weights drawn from its shapes at full width."""
    return scene.make_state(dict(CFG, scene=str(path),
                                 gaussian_capacity=320), seed, "cpu")


def _port(field: dict, skip_dropped=False):
    """The port's field parameters holding the benchmark's weights; with
    ``skip_dropped`` the skip layer keeps only its hidden rows."""
    params = init_deform(DEFORM, torch.Generator().manual_seed(0), "cpu")
    named = dict(params.named_parameters())
    assert set(named) == set(field)
    with torch.no_grad():
        for k, v in field.items():
            if skip_dropped and k == "layers.5.w":
                named[k].data = v[v.shape[0] - 256:].clone()
            else:
                named[k].copy_(v)
    return params


def _outputs(d: dict):
    return d["d_xyz"], d["d_rotation"], d["d_scaling"]


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_port_matches_the_plain_reference(t, tiny_scene):
    """Outputs and every leaf's gradient under a seeded cotangent.  Both
    sides run the same float32 products and sums in the same order, and
    agree bitwise on one CPU thread; rtol 1e-5 of each output and of
    each leaf's largest gradient entry leaves room for a BLAS that
    blocks the products otherwise (a few float32 ulps through the eight
    layers), and is 100x under what the dropped skip reads."""
    st = _state(tiny_scene)
    x = st["gauss"]["xyz"]
    params = _port(st["field"])
    ref_field = {k: v.clone().requires_grad_(True)
                 for k, v in st["field"].items()}
    got = _outputs(apply_deform_field(params, DEFORM, x, t))
    want = ref_mlp.forward(dict(st, field=ref_field), CFG, t, 10 ** 9)
    gen = torch.Generator().manual_seed(5)
    cot = [torch.randn(w.shape, generator=gen) for w in want]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.detach().abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
    names = sorted(ref_field)
    named = dict(params.named_parameters())
    g_port = torch.autograd.grad(sum((a * c).sum() for a, c in
                                     zip(got, cot)),
                                 [named[k] for k in names])
    g_ref = torch.autograd.grad(sum((b * c).sum() for b, c in
                                    zip(want, cot)),
                                [ref_field[k] for k in names])
    for k, a, b in zip(names, g_port, g_ref):
        assert float(b.abs().max()) > 0, k
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=k)


def test_dropped_skip_is_caught(tiny_scene, monkeypatch):
    """A planted fault: the port's skip concat dropped (layer 5 fed the
    hidden state alone, its weight's hidden rows kept).  The comparison
    above reads it 100x past its tolerance."""
    st = _state(tiny_scene)
    monkeypatch.setattr(deform_mlp.MLPConfig, "skip",
                        property(lambda self: -1))
    params = _port(st["field"], skip_dropped=True)
    with torch.no_grad():
        got = _outputs(apply_deform_field(params, DEFORM,
                                          st["gauss"]["xyz"], 0.5))
        want = ref_mlp.forward(st, CFG, 0.5, 10 ** 9)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want))
    assert worst > 100 * 1e-5


def test_span_and_counter(tiny_scene):
    """Under a profiler: one d2dgs.mlp span per mlp_forward call, inside
    d2dgs.field when the field is reached through deform_gaussians, and
    field.mlp_ops = 2 * rows * sum(fan_in * fan_out), which is also the
    benchmark's count of the field's operations.  Off: no record."""
    st = _state(tiny_scene)
    params = _port(st["field"])
    x = st["gauss"]["xyz"]
    apply_deform_field(params, DEFORM, x, 0.5)
    assert trace.records() == [] and trace.report()["counters"] == {}
    holder = type("Slot", (), {"mlp": params})()
    with profile(activities=[ProfilerActivity.CPU]):
        apply_deform_field(params, DEFORM, x, 0.5)
        deform_gaussians(holder, DEFORM, x, 0.25)
    recs = trace.records()
    assert [r.name for r in recs] == ["d2dgs.mlp", "d2dgs.field",
                                      "d2dgs.mlp"]
    assert recs[0].parent is None and recs[2].parent == 1
    n = x.shape[0]
    ops = trace.report()["counters"]["field.mlp_ops"]
    assert ops == 2 * n * OPS_PER_ROW
    assert ops == 2 * ref_mlp.fwd_ops(CFG, n)[0]
    assert ref_mlp.fwd_ops(CFG, n)[1] == 0.0


def _reader(name):
    return cells.reader(BENCH / "metrics", name)


def test_mlp_readers():
    """mlp_ms.train: d2dgs.mlp's stream ms per step; mlp_roofline.train:
    3 x field.mlp_ops at the float32 peak over the matrix products'
    device time (%).  None without the span, its stream time, the
    counter, the products or the trace."""
    span = dict(count=2, host_ms=9.0, host_self_ms=9.0, stream_ms=8.0,
                parents=["d2dgs.field"])
    rep = {"units": 2, "spans": {"d2dgs.mlp": span},
           "counters": {"field.mlp_ops": 4.0e11}}
    tr = {"units": 2, "op_device_s": {"aten::mm": 0.03, "aten::addmm": 0.01,
                                      "aten::add": 5.0}}
    ms, roof = _reader("mlp_ms.train"), _reader("mlp_roofline.train")
    ctx = {"trace": tr, "spans": rep}
    assert ms(ctx) == pytest.approx(4.0)
    assert roof(ctx) == pytest.approx(100 * 3 * 4.0e11
                                      / counts.PEAK_F32_FLOPS / 0.04)
    assert 0 < roof(ctx) < 100
    no_span = dict(rep, spans={})
    cpu = dict(rep, spans={"d2dgs.mlp": dict(span, stream_ms=None)})
    no_count = dict(rep, counters={})
    no_mm = dict(tr, op_device_s={"aten::add": 5.0})
    for read, c in ((ms, {"trace": tr, "spans": no_span}),
                    (ms, {"trace": tr, "spans": cpu}),
                    (ms, {"spans": rep}),
                    (roof, {"trace": tr, "spans": no_count}),
                    (roof, {"trace": no_mm, "spans": rep}),
                    (roof, {"trace": tr, "spans": None}),
                    (roof, {"spans": rep})):
        assert read(c) is None


@pytest.mark.parametrize("workload", ["mlp-train", "hash-serve"])
def test_tiny_run_is_correct(workload, tiny_scene):
    ok, checks = run_tiny(tiny_cell(workload, tiny_scene))
    assert ok, checks


def test_half_batch_fault_is_caught(tiny_scene, monkeypatch):
    """The image L1 over half the batch, planted in the port's step,
    reads incorrect in mlp-train."""
    import d2dgs_torch.train.trainer as T
    half = lambda a, b: torch.mean(torch.abs(a[: a.shape[0] // 2]
                                             - b[: b.shape[0] // 2]))
    monkeypatch.setattr(T, "l1", half)
    ok, checks = run_tiny(tiny_cell("mlp-train", tiny_scene))
    assert not ok and checks["loss_gap"]["value"] > \
        checks["loss_gap"]["limit"]
