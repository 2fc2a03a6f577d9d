"""The HexPlane field (``deform_type`` "hexplane", 4D Gaussian Splatting's
HexPlaneField and Deformation at its D-NeRF settings) at its published
widths against the benchmark's plain reference
(``benchmark/benchlib/fields/hexplane.py``), the planes' regulariser, the
planted faults the comparison must catch, the span and counter, the
benchmark's readers of them, and tiny CPU runs of the cell
``hexplane-train``.  This file imports torch, d2dgs_torch and the
benchmark's ``benchlib`` only:

    python -m pytest tests/test_torch_hexplane.py -q
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d2dgs_torch import trace
from d2dgs_torch.models import hexplane_deform as hd
from d2dgs_torch.models.deform import (apply_deform_field, deform_gaussians,
                                       init_deform)
from d2dgs_torch.train.config import TrainConfig

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH), str(BENCH / "tests")]
from benchlib import cells, counts, scene  # noqa: E402
from benchlib.fields import hexplane as ref_hex  # noqa: E402
# the harness's tiny cut (48x48 views, capacity 512) and its 300-surfel
# scene, shared so that the two stay one
from test_bench_harness import (run_tiny, tiny_cell,  # noqa: E402,F401
                                tiny_scene)

torch.set_num_threads(1)

BENCHJ = cells.load_benchmark()
CFG = cells.cell(BENCHJ, "hexplane-train")["config"]
TC = TrainConfig(deform_type="hexplane")
DEFORM = TC.deform_cfg
# Both sides compute the same float32 samples, products and products of
# matrices, in another order: aten's bilinear weights are differences of
# corner coordinates, the reference's 1 - frac, and the two sum the four
# corners, the gathers' gradients and the regulariser's means otherwise.
# The worst gaps measured on this scene are 3.6e-7 of an output's largest
# entry and 1.7e-6 of a leaf gradient's; 1e-5 leaves room for a BLAS that
# blocks the 64-wide products otherwise, and is >= 100x under what each
# planted fault reads.
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _empty_record():
    trace.reset()
    yield
    trace.reset()


def _cfg(path) -> dict:
    """The configuration on the tiny scene at capacity 320 (20 dead
    slots at the origin): the reference's aabb is that scene's."""
    return dict(CFG, scene=str(path), gaussian_capacity=320)


def _state(path, seed=2 ** 31 + 77):
    """The tiny scene with the field's weights drawn from its shapes at
    full width."""
    return scene.make_state(_cfg(path), seed, "cpu")


def _port(field: dict, path):
    """The port's field holding the benchmark's weights, its aabb set
    from the scene's surfels, as the Trainer sets it from its point
    cloud."""
    pcl = np.load(path)["xyz"]
    params = init_deform(DEFORM, torch.Generator().manual_seed(0), "cpu",
                         init_pcl=pcl)
    named = dict(params.named_parameters())
    assert set(named) == set(field)
    with torch.no_grad():
        for k, v in field.items():
            named[k].copy_(v)
    return params


def _outputs(d: dict):
    return d["d_xyz"], d["d_rotation"], d["d_scaling"]


def _worst(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def _grads(outs, cot, leaves, extra=None):
    loss = sum((a * c).sum() for a, c in zip(outs, cot))
    if extra is not None:
        loss = loss + extra
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_port_matches_the_plain_reference(t, tiny_scene):
    """Outputs and every plane's and MLP leaf's gradient under a seeded
    cotangent: the port's with its regulariser added to the loss, the
    reference's with the regulariser's gradient entering through its
    d_xyz (``WithRegulariser``).  t = 0 and 1 sample the time planes'
    middle and last rows exactly (the border); 0.37 between rows."""
    st = _state(tiny_scene)
    x = st["gauss"]["xyz"]
    params = _port(st["field"], tiny_scene)
    ref_field = {k: v.clone().requires_grad_(True)
                 for k, v in st["field"].items()}
    got = _outputs(apply_deform_field(params, DEFORM, x, t))
    want = ref_hex.forward(dict(st, field=ref_field), _cfg(tiny_scene), t,
                           10 ** 9)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.detach().abs().max())
        torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * scale)
    gen = torch.Generator().manual_seed(5)
    cot = [torch.randn(w.shape, generator=gen) for w in want]
    names = sorted(ref_field)
    named = dict(params.named_parameters())
    g_port = _grads(got, cot, [named[k] for k in names],
                    hd.plane_regulariser(params, DEFORM.hexplane))
    g_ref = _grads(want, cot, [ref_field[k] for k in names])
    for k, a, b in zip(names, g_port, g_ref):
        assert float(b.abs().max()) > 0, k
        torch.testing.assert_close(a, b, rtol=RTOL,
                                   atol=RTOL * float(b.abs().max()), msg=k)


def _planes(field: dict) -> dict:
    return {k: v.clone().requires_grad_(True) for k, v in field.items()
            if k.startswith("grids.")}


def test_regulariser_matches_the_reference(tiny_scene):
    """R's value and its gradient on every plane: the port's stacked
    means (three times a leaf's mean) against the reference's mean of
    each plane."""
    st = _state(tiny_scene)
    params = _port(st["field"], tiny_scene)
    planes = _planes(st["field"])
    r_port = hd.plane_regulariser(params, DEFORM.hexplane)
    r_ref = ref_hex.regulariser(planes, CFG)
    assert float(r_ref.detach()) > 0
    torch.testing.assert_close(r_port, r_ref, rtol=RTOL, atol=0.0)
    named = dict(params.named_parameters())
    names = sorted(planes)
    for k, a, b in zip(names, torch.autograd.grad(
            r_port, [named[k] for k in names]),
            torch.autograd.grad(r_ref, [planes[k] for k in names])):
        torch.testing.assert_close(a, b, rtol=RTOL,
                                   atol=RTOL * float(b.abs().max()), msg=k)


def test_reference_backward_is_the_gradient_of_l_plus_r(tiny_scene,
                                                        monkeypatch):
    """The reference's d_xyz carries R's gradient: through it, a loss of
    the outputs gets the gradient that autograd gives L + R, R added to
    the loss of the same outputs computed without ``WithRegulariser``.
    The two differ only in the order the planes' two gradients are
    summed."""
    st = _state(tiny_scene)
    gen = torch.Generator().manual_seed(9)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in st["field"].items()}
    names = sorted(leaves)
    cfg = _cfg(tiny_scene)
    out = ref_hex.forward(dict(st, field=leaves), cfg, 0.37, 10 ** 9)
    cot = [torch.randn(o.shape, generator=gen) for o in out]
    via = _grads(out, cot, [leaves[k] for k in names])
    monkeypatch.setattr(ref_hex.WithRegulariser, "apply",
                        lambda d, *_: d)
    plain = ref_hex.forward(dict(st, field=leaves), cfg, 0.37, 10 ** 9)
    direct = _grads(plain, cot, [leaves[k] for k in names],
                    ref_hex.regulariser(leaves, CFG))
    for k, a, b in zip(names, via, direct):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()), msg=k)
    # R's own gradient on the planes is >= 100x that tolerance
    planes = [k for k in names if k.startswith("grids.")]
    r_grads = torch.autograd.grad(ref_hex.regulariser(leaves, CFG),
                                  [leaves[k] for k in planes])
    assert max(float(g.abs().max() / via[names.index(k)].abs().max())
               for k, g in zip(planes, r_grads)) > 100 * 1e-6


def _drop_zt_plane(orig):
    """A planted fault: the (z,t) plane left out of each scale's
    product."""
    def sample(planes, coords):
        out = orig(planes, coords)
        if planes.shape[2] == CFG["kplanes_config"]["resolution"][3]:
            out = torch.cat([out[:2], torch.ones_like(out[2:])])
        return out
    return sample


def _t_to_signed(orig):
    """A planted fault: t mapped to [-1, 1] before the time planes."""
    return lambda params, x, t: orig(params, x, 2.0 * t - 1.0)


@pytest.mark.parametrize("fault", ["plane_left_out", "t_signed"])
def test_planted_field_fault_is_caught(fault, tiny_scene, monkeypatch):
    """Each fault, planted in the port, reads >= 100x the comparison's
    tolerance on the outputs."""
    st = _state(tiny_scene)
    params = _port(st["field"], tiny_scene)
    if fault == "plane_left_out":
        monkeypatch.setattr(hd, "_sample", _drop_zt_plane(hd._sample))
    else:
        monkeypatch.setattr(hd, "hexplane_features",
                            _t_to_signed(hd.hexplane_features))
    with torch.no_grad():
        got = _outputs(apply_deform_field(params, DEFORM,
                                          st["gauss"]["xyz"], 0.37))
        want = ref_hex.forward(st, _cfg(tiny_scene), 0.37, 10 ** 9)
    assert _worst(got, want) > 100 * RTOL


def test_second_difference_along_the_width_is_caught(tiny_scene,
                                                     monkeypatch):
    """A planted fault: the smoothness taken along each plane's width
    (for a time plane, along space rather than time).  R reads >= 100x
    the tolerance off."""
    st = _state(tiny_scene)
    params = _port(st["field"], tiny_scene)
    orig = hd.plane_smoothness
    monkeypatch.setattr(hd, "plane_smoothness",
                        lambda p: orig(p.transpose(-1, -2)))
    with torch.no_grad():
        r_port = hd.plane_regulariser(params, DEFORM.hexplane)
        r_ref = ref_hex.regulariser(st["field"], CFG)
    assert abs(float(r_port / r_ref) - 1.0) > 100 * RTOL


def test_defaults_are_the_configuration_widths():
    """The port's HexPlaneConfig defaults are the configuration file's
    widths and regulariser weights, 4DGS's D-NeRF settings."""
    hc = hd.HexPlaneConfig()
    assert DEFORM.hexplane == hc
    kp = CFG["kplanes_config"]
    assert (kp["grid_dimensions"], kp["input_coordinate_dim"]) == (2, 4)
    assert hc.output_coordinate_dim == kp["output_coordinate_dim"]
    assert list(hc.resolution) == kp["resolution"]
    assert list(hc.multires) == CFG["multires"]
    assert (hc.defor_depth, hc.net_width) == (CFG["defor_depth"],
                                              CFG["net_width"])
    assert CFG["no_do"] and CFG["no_dshs"]
    for k in ("plane_tv_weight", "time_smoothness_weight", "l1_time_planes"):
        assert getattr(hc, k) == CFG[k], k
    shapes = dict(ref_hex.plane_shapes(CFG))
    assert shapes == {f"grids.{s}.{leaf}": shape
                      for s, m in enumerate(hc.multires)
                      for leaf, shape in zip(("space", "time"),
                                             hc.plane_shapes(m))}
    assert sum(np.prod(v) for v in shapes.values()) == 2_426_880
    fresh = init_deform(DEFORM, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for k, p in fresh.named_parameters()
               if not k.startswith("grids.")) == 17_225


def test_initialisation_is_4dgs(tiny_scene):
    """Spatial planes in U(0.1, 0.5), time planes ones, the aabb the
    point cloud's [max, min] (the default +-bounds without one)."""
    pcl = np.load(tiny_scene)["xyz"]
    p = init_deform(DEFORM, torch.Generator().manual_seed(1), "cpu",
                    init_pcl=pcl)
    for grid in p["grids"]:
        space = grid["space"].detach()
        assert 0.1 <= float(space.min()) < float(space.max()) <= 0.5
        assert bool((grid["time"] == 1.0).all())
    np.testing.assert_array_equal(p.aabb.numpy(),
                                  np.stack([pcl.max(0), pcl.min(0)]))
    assert "aabb" not in dict(p.named_parameters())
    q = init_deform(DEFORM, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(q.aabb, torch.tensor([[1.6] * 3, [-1.6] * 3]))


def test_span_and_counter(tiny_scene):
    """Under a profiler: one d2dgs.hexplane span per field call, inside
    d2dgs.field when reached through deform_gaussians, field.plane_samples
    = rows x 12, and the sampling and its backward run as the operators
    plane_roofline.train reads.  Off: no record."""
    st = _state(tiny_scene)
    params = _port(st["field"], tiny_scene)
    x = st["gauss"]["xyz"]
    apply_deform_field(params, DEFORM, x, 0.5)
    assert trace.records() == [] and trace.report()["counters"] == {}
    holder = types.SimpleNamespace(mlp=params)
    alive = torch.ones(x.shape[0], dtype=torch.bool)
    alive[-20:] = False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d = deform_gaussians(holder, DEFORM,
                             types.SimpleNamespace(xyz=x, alive=alive), 0.25)
        d["d_xyz"].sum().backward()
    recs = trace.records()
    assert [r.name for r in recs] == ["d2dgs.field", "d2dgs.hexplane"]
    assert recs[1].parent == 0
    assert trace.report()["counters"]["field.plane_samples"] == \
        (x.shape[0] - 20) * 12 == ref_hex.samples_per_row(CFG) * 300
    ops = {e.name for e in prof.events()}
    reader = cells.reader(BENCH / "metrics", "plane_roofline.train")
    assert set(reader.__globals__["SAMPLE_OPS"]) <= ops


def _reader(name):
    return cells.reader(BENCH / "metrics", name)


def test_hexplane_readers():
    """hexplane_ms.train: d2dgs.hexplane's stream ms per step;
    plane_roofline.train: the least time of the sampling of
    field.plane_samples / 12 rows a step (bytes-bound) over the sampling
    operators' own device time a step (%).  None without the span, its
    stream time, the counter, the operators or the trace."""
    span = dict(count=2, host_ms=3.0, host_self_ms=3.0, stream_ms=5.0,
                parents=["d2dgs.field"])
    rows = 83_252
    rep = {"units": 2, "spans": {"d2dgs.hexplane": span},
           "counters": {"field.plane_samples": 2 * 12 * rows}}
    tr = {"units": 2, "op_device_s": {"aten::grid_sampler_2d": 0.001,
                                      "aten::grid_sampler_2d_backward": 0.005,
                                      "aten::add": 5.0}}
    ms, roof = _reader("hexplane_ms.train"), _reader("plane_roofline.train")
    ctx = {"trace": tr, "spans": rep, "cfg": CFG}
    assert ms(ctx) == pytest.approx(2.5)
    # 2 x 2,426,880 plane values + 83,252 x (4 + 128) floats at 3.35 TB/s
    least = 4 * (2 * 2_426_880 + rows * 132) / counts.PEAK_BYTES_S
    assert roof(ctx) == pytest.approx(100 * least / 0.003)
    assert 0 < roof(ctx) < 100
    no_span = dict(rep, spans={})
    cpu = dict(rep, spans={"d2dgs.hexplane": dict(span, stream_ms=None)})
    no_count = dict(rep, counters={})
    no_ops = dict(tr, op_device_s={"aten::add": 5.0})
    for read, c in ((ms, {"trace": tr, "spans": no_span}),
                    (ms, {"trace": tr, "spans": cpu}),
                    (ms, {"spans": rep}),
                    (roof, {"trace": tr, "spans": no_count, "cfg": CFG}),
                    (roof, {"trace": no_ops, "spans": rep, "cfg": CFG}),
                    (roof, {"trace": tr, "spans": None, "cfg": CFG}),
                    (roof, {"spans": rep, "cfg": CFG})):
        assert read(c) is None


def test_field_counts():
    """fwd_ops: the sampling (12 blends of 32 channels, 7 operations a
    channel, and two products of six samples) and the MLP's 2 x (64x64 +
    3 x (64x64 + 64 x k)) per row; the sampling's least work is bound
    by its bytes at the cell's rows."""
    grad, nograd = ref_hex.fwd_ops(CFG, 10)
    assert nograd == 0.0
    mlp = 2 * (64 * 64 + 3 * 64 * 64 + 64 * (3 + 2 + 4))
    assert grad == 10 * (32 * (12 * 7 + 2 * 5) + mlp)
    w = ref_hex.sample_work(CFG, 83_252)
    assert w["bytes"] / counts.PEAK_BYTES_S > \
        w["ops"] / counts.PEAK_F32_FLOPS


def _first_moments(mode, weights, monkeypatch):
    """The field group's Adam first moments after one main-stage step of
    a tiny hexplane Trainer whose regulariser has the ``weights``:
    ``main_stage_step`` ("plain"), the batched step over one camera
    ("batched") or the sharded step on a 1 x 1 grid ("sharded")."""
    from d2dgs_torch.data.synthetic import make_video_dataset
    from d2dgs_torch.parallel import batched_main_step
    from d2dgs_torch.train import trainer as T
    from torch_tiny import TINY
    cfg = dataclasses.replace(TINY, deform_type="hexplane", warm_up=0)
    hexplane = dataclasses.replace(hd.HexPlaneConfig(), **weights)
    deform_cfg = TrainConfig.deform_cfg.fget
    cams, imgs, pts, cols = make_video_dataset(
        3, n_cams=2, n_times=2, H=32, W=32, n_gauss=16, device="cpu")
    tr = T.Trainer(cfg, cams, imgs, pts, cols, cameras_extent=4.0, seed=0,
                   device="cpu")
    sched = dict(warm=0.0, lambda_normal=0.02, lambda_dist=0.0,
                 lambda_arap=0.0, deform_lr=1e-3, xyz_lr=1e-4, step=100)
    gt = torch.as_tensor(imgs[0])
    with monkeypatch.context() as m:
        m.setattr(TrainConfig, "deform_cfg", property(
            lambda c: dataclasses.replace(deform_cfg(c), hexplane=hexplane)))
        if mode == "plain":
            st, _ = T.main_stage_step(tr.state, cams[0], gt, cfg, sched)
        elif mode == "batched":
            st, _ = batched_main_step(tr.state, [cams[0]], gt[None], cfg,
                                      sched)
        else:
            tr.enable_sharded_training((1, 1))
            st, _ = tr._sharded_step(tr.state, [cams[0]], gt[None], sched)
    return {k: v.clone() for k, v in st.mlp_opt.mu.items()}


@pytest.mark.parametrize("mode", ["batched", "sharded"])
def test_batched_and_sharded_steps_add_the_regulariser(mode, monkeypatch):
    """The data-parallel and the (data x gauss) steps add the planes'
    regulariser as main_stage_step does: the field's first moments equal
    the plain step's, which moves by > 1e-3 without the term.  The
    weights are 1000x the published ones, so that the term shows beside
    the image loss's gradient at the tiny scene."""
    big = dict(plane_tv_weight=0.1, time_smoothness_weight=10.0,
               l1_time_planes=0.1)
    plain = _first_moments("plain", big, monkeypatch)
    got = _first_moments(mode, big, monkeypatch)
    for k, v in plain.items():
        torch.testing.assert_close(got[k], v, rtol=1e-6,
                                   atol=1e-6 * float(v.abs().max()), msg=k)
    off = _first_moments("plain", dict(plane_tv_weight=0.0,
                                       time_smoothness_weight=0.0,
                                       l1_time_planes=0.0), monkeypatch)
    assert max(float((off[k] - v).abs().max() / v.abs().max())
               for k, v in plain.items() if k.startswith("grids.")) > 1e-3


def _tiny_run(path):
    """A tiny CPU run of hexplane-train, judged by its limits."""
    return run_tiny(tiny_cell("hexplane-train", path))


def test_tiny_run_is_correct(tiny_scene):
    ok, checks = _tiny_run(tiny_scene)
    assert ok, checks


def test_half_batch_fault_is_caught(tiny_scene, monkeypatch):
    """The image L1 over half the batch, planted in the port's step,
    reads incorrect in hexplane-train."""
    import d2dgs_torch.train.trainer as T
    half = lambda a, b: torch.mean(torch.abs(a[: a.shape[0] // 2]
                                             - b[: b.shape[0] // 2]))
    monkeypatch.setattr(T, "l1", half)
    ok, checks = _tiny_run(tiny_scene)
    assert not ok and checks["loss_gap"]["value"] > \
        checks["loss_gap"]["limit"]


def test_regulariser_left_out_is_caught(tiny_scene, monkeypatch):
    """The planes' regulariser left out of the port's step reads
    incorrect: without it Adam moves only the plane values the step's
    rows sample, where R moves every one, so the planes' first gradient
    and their change over the three steps fall short of the reference's
    (``grad_gap`` and ``update_gap``)."""
    import d2dgs_torch.train.trainer as T
    monkeypatch.setattr(T, "add_field_regulariser",
                        lambda loss, *args, **kw: loss)
    ok, checks = _tiny_run(tiny_scene)
    assert not ok
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    assert checks["update_gap"]["value"] > checks["update_gap"]["limit"]
