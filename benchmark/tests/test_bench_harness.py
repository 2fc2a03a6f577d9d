"""CPU tests of the benchmark's harness: the import rule, the cells found
from the data files, the frozen arithmetic, the result line, and the
comparison refusing a broken timed path (each fault the cells can have,
planted in the port under a tiny CPU run of ``drive.run_train`` or
``drive.run_serve``, where the port blends through its plain version).

    python -m pytest benchmark/tests -q
"""
import ast
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

from benchlib import (cells, compare, counts, drive, readers,  # noqa: E402
                      reference, scene)

torch.set_num_threads(1)
FORBIDDEN = ("jax", "jaxlib", "flax", "d2dgs_tpu")
# the yardstick: nothing of the port (only program.py reaches it)
YARDSTICK = ("reference.py", "scene.py", "compare.py", "counts.py",
             "control.py", "tracing.py", "readers.py", "cells.py")


def imported(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("__import__", "import_module"):
                names.append(node.args[0].value)
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_import_rule(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & set(FORBIDDEN), path
    if path.parent.name == "benchlib" and path.name in YARDSTICK or \
            path.parent.name == "fields":
        assert "d2dgs_torch" not in tops, path


def test_import_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jaxtyping\nimport d2dgs_torch.ops\n"
                 "def f():\n    import jax.numpy\n")
    tops = {n.split(".")[0] for n in imported(p)}
    assert tops & set(FORBIDDEN) == {"jax"}


def test_runtime_guard_names_whole_modules(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "d2dgs_tpu.ops", object())
    assert run.forbidden_modules() == ["d2dgs_tpu"]


@pytest.mark.parametrize("plant", ["jax", "d2dgs_tpu"])
def test_runtime_guard_sees_what_a_reader_loads(plant, tmp_path, capsys,
                                                monkeypatch):
    """A per-layer reader that loads a forbidden module (here a stub of
    that name) leaves no result: the guard looks after the readers ran."""
    import run
    (tmp_path / f"{plant}.py").write_text("")
    mdir = tmp_path / "metrics"
    mdir.mkdir()
    (mdir / "planted.serve.py").write_text(
        f"import {plant}\n\ndef read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    for m in [m for m in sys.modules if m.split(".")[0] == plant]:
        monkeypatch.delitem(sys.modules, m)
    c = dict(cells.cell(BENCHJ, "node-serve"), metrics_dir=mdir,
             per_layer=[{"name": "planted.serve", "unit": "%"}])
    out = dict(kind="serve", attempted=1, failed=0, peak=1,
               e2e={"view_ms": 1.0, "view_ms_p95": 1.0, "setup_s": 1.0},
               numbers={"pixel_diff_share": 0.0, "max_level_diff": 0},
               trace={"units": 1, "window_s": 1.0, "busy_s": 0.5,
                      "launches": 1, "by_name": {}, "op_device_s": {},
                      "idle_gaps": []})
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    try:
        rc = run.report(c, dict(out), True, dict(dev))
        assert plant in sys.modules
    finally:
        sys.modules.pop(plant, None)
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == "" and plant in cap.err
    c["metrics_dir"] = BENCH / "metrics"
    c["per_layer"] = cells.cell(BENCHJ, "node-serve")["per_layer"]
    assert run.report(c, dict(out), True, dict(dev)) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]


def test_fields_found_by_deform_type():
    from benchlib import fields
    for c in BENCHJ["configs"]:
        cfg = cells._json(REPO / c["file"])
        f = fields.field(cfg["deform_type"])
        for name in ("shapes", "extra_state", "forward", "fwd_ops"):
            assert callable(getattr(f, name)), (c["name"], name)
        assert scene.field_shapes(cfg) == f.shapes(cfg)
    with pytest.raises(ValueError, match="no field"):
        fields.field("no_such_field")


def test_no_card_no_result(capsys, monkeypatch):
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "node-serve", "--seed", "1", "--seconds",
                   "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------------------
# BENCHMARK.json and the cells it names
# ----------------------------------------------------------------------

BENCHJ = cells.load_benchmark()
NAME_OK = lambda s: (0 < len(s) <= 64 and s[0].isalnum() or s[:1] == "_") \
    and all(c.isalnum() or c in "_.-" for c in s) and s.isascii()


def test_benchmark_keys_and_names():
    assert set(BENCHJ) == {"command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCHJ["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHJ[k]]
    assert len(names) == len(set(names))
    assert all(NAME_OK(n) for n in names)
    for c in BENCHJ["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCHJ["paths"][0] + "/")
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
    for m in BENCHJ["per_layer"]:
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCHJ["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCHJ["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCHJ["end_to_end"]}
    for m in BENCHJ["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        for w in m["workloads"]:
            assert cells.applies(e2e[m["moves"]], w), (m["name"], w)
    assert len(json.dumps(BENCHJ)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCHJ["workloads"]])
def test_cell_found_from_data(workload):
    c = cells.cell(BENCHJ, workload)
    assert c["traffic"]["kind"] in drive.RUNNERS
    assert set(c["limits"]) <= {"loss_gap", "grad_gap", "update_gap",
                                "pixel_diff_share", "max_level_diff"}
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(cells.reader(c["metrics_dir"], m["name"]))
    assert (BENCH / c["config"]["scene"]).exists()


# ----------------------------------------------------------------------
# the frozen arithmetic
# ----------------------------------------------------------------------

def tiny_walk_scene():
    """A 32x32 view of 40 surfels and its binning, by the reference."""
    g = torch.Generator().manual_seed(3)
    n = 40
    cam = scene.camera(0.3, 0.2, {"height": 32, "width": 32,
                                  "orbit_radius": 3.0, "fov": 0.8}, 0.5,
                       "cpu")
    means = (torch.rand((n, 3), generator=g) - 0.5) * 0.8
    scales = 0.05 + 0.1 * torch.rand((n, 2), generator=g)
    quats = reference.quat_normalize(torch.randn((n, 4), generator=g))
    opac = 0.2 + 0.7 * torch.rand((n,), generator=g)
    prep = reference.preprocess(means, scales, quats, cam)
    opac = torch.where(prep["valid"], opac, 0.0)
    order, rank, start, count = reference.bin_pairs(prep, opac, cam)
    feats = torch.cat([prep["T"].reshape(n, 9), prep["center"],
                       prep["normal"], torch.rand((n, 3), generator=g),
                       opac[:, None]], -1)[order]
    return feats, rank, start, count, cam


def test_walk_counts_match_a_pixel_by_pixel_walk():
    feats, rank, start, count, cam = tiny_walk_scene()
    gx, _ = reference.grid(cam)
    tiles = torch.arange(start.shape[0])
    st, last = reference.walk(feats, rank, start, count, gx, tiles)
    pix = reference.tile_pixels(gx, tiles)
    for t in range(start.shape[0]):
        for p in (0, 37, 255):
            T, n_eval, n_blend, lastp = 1.0, 0, 0, -1
            for j in range(int(count[t])):
                f = feats[rank[int(start[t]) + j]]
                a, _ = reference.responses(f[0:9].reshape(1, 3, 3),
                                           f[9:11][None], f[17:18],
                                           pix[t, p][None])
                a = float(a[0, 0])
                n_eval += 1
                if a > 0 and T * (1 - a) < reference.T_CUTOFF:
                    break
                if a > 0:
                    T *= 1 - a
                    n_blend, lastp = n_blend + 1, j
            assert st[t, reference.ROW_N_EVAL, p] == n_eval
            assert st[t, reference.ROW_N_BLEND, p] == n_blend
            assert last[t, p] == lastp
            assert math.isclose(float(st[t, reference.ROW_T, p]), T,
                                rel_tol=1e-5)


def test_blend_bounds_and_rooflines():
    walk = dict(n_eval=1000.0, n_blend=400.0, n_walk_bwd=900.0, n_sorted=50,
                n_pairs=300, n_tiles=4, n_ckpt=1)
    fw = counts.blend_fwd(walk, False)
    assert fw["ops"] == 46 * 1000 + 39 * 400
    assert fw["bytes"] == 50 * 18 * 4 + 300 * 4 + 4 * 8 + 4 * 16 * 256 * 4
    assert counts.blend_fwd(walk, True)["bytes"] == \
        fw["bytes"] + 4 * 2 * 256 * 4 + 11 * 256 * 4
    bw = counts.blend_bwd(walk)
    assert bw["ops"] == 46 * 900 + 161 * 400
    least = counts.least_seconds(fw)
    assert least == max(fw["ops"] / 67e12, fw["bytes"] / 3.35e12)
    tr = {"by_name": {"void fwd_pass_a<true>(...)": 2 * least,
                      "void fwd_pass_b<true>(...)": 1 * least,
                      "elementwise": 5.0},
          "units": 2, "window_s": 1.0, "busy_s": 0.25, "launches": 10,
          "op_device_s": {"aten::_index_put_impl_": 0.004, "aten::mm": 1.0}}
    ctx = {"kind": "serve", "trace": tr, "walk": walk,
           "counters": {"k1_launches": 1}}
    assert readers.k1_roofline(ctx) == pytest.approx(100.0 / 3)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.launches_per_unit(ctx) == 5
    assert readers.index_bwd_ms(ctx) == pytest.approx(2.0)
    assert readers.k2_roofline(ctx) is None        # no K2 launched
    assert readers.k1_roofline(dict(ctx, walk=None)) is None


@pytest.mark.parametrize("workload", ["node-train", "hash-train",
                                      "node-serve"])
def test_mfu_counts_the_whole_unit(workload):
    c = cells.cell(BENCHJ, workload)
    cfg, tf = c["config"], c["traffic"]
    walk = dict(n_eval=3e7, n_blend=1e7, n_walk_bwd=2.5e7, n_sorted=200000,
                n_pairs=3e5, n_tiles=2500, n_ckpt=100)
    n = 83252
    grad, nograd = counts.field_fwd_ops(cfg, n)
    if cfg["deform_type"] == "node":
        # the 8x256 MLP at 1024 nodes, the K-nearest-node distances
        assert grad > 2 * 1024 * 256 * 256 * 6 and nograd > 2 * n * 1024 * 11
    else:
        assert grad > 2 * n * 256 * 256 * 4 and nograd == 0
    ctx = dict(kind=tf["kind"], walk=walk, n_live=n, unit_s=0.05, cfg=cfg,
               traffic=tf)
    ops = (counts.train_step_ops(cfg, walk, n, 800, 800)
           if tf["kind"] == "train" else counts.view_ops(cfg, walk, n))
    assert readers.mfu(ctx) == pytest.approx(100 * ops / 0.05 / 67e12)
    assert 0 < readers.mfu(ctx) < 100


def test_compare_numbers():
    a = {"x": torch.ones(4), "y": torch.full((2,), 1e-9)}
    assert compare.norm_gap(a, a) == 0.0
    b = {"x": 2 * torch.ones(4), "y": a["y"]}
    assert compare.norm_gap(b, a) == pytest.approx(1.0)
    assert compare.leaf_gaps(b, a)["y"] == 0.0
    assert compare.roundoff_leaves({"x": torch.ones(4), "y": a["y"],
                                    "z": torch.ones(3)}) == {"y"}
    nan = compare.norm_gap({"x": torch.full((4,), float("nan")),
                            "y": a["y"]}, a)
    assert nan != nan
    ok, checks = compare.judge({"g": nan}, {"g": 1.0})
    assert not ok and checks["g"]["limit"] == 1.0
    img = torch.zeros((4, 4, 3), dtype=torch.uint8)
    alt = img.clone()
    alt[0, 0, 0] = 3
    n = compare.serve_numbers([(img, img), (alt, img)])
    assert n["pixel_diff_share"] == pytest.approx(1 / 48)
    assert n["max_level_diff"] == 3


def test_sampler_picks_follow_the_trainer():
    from d2dgs_torch.train.trainer import Trainer
    tr = Trainer.__new__(Trainer)
    tr.rng, tr._stack = np.random.RandomState(77), []
    tr.cfg = type("C", (), {"progressive_train": False})()
    tr.iteration, tr.cameras = 1, list(range(9))
    picks = []
    for _ in range(12):
        if not tr._stack:
            tr._refill_stack()
        picks.append(tr._stack.pop(tr.rng.randint(len(tr._stack))))
    assert drive.sampler_picks(77, 9, 12) == picks


# ----------------------------------------------------------------------
# the result line
# ----------------------------------------------------------------------

def test_result_line_format():
    import run
    c = cells.cell(BENCHJ, "node-serve")
    out = dict(kind="serve", attempted=10, failed=0, peak=123,
               e2e={"view_ms": 10.5, "view_ms_p95": 12.25, "setup_s": 20.0},
               numbers={"pixel_diff_share": 0.0, "max_level_diff": 0})
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 123}
    r = run.result_line(c, out, False, dict(dev))
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True
    assert r["metrics"]["view_ms"] == {"value": 10.5, "unit": "ms"}
    assert set(r["metrics"]) == {"view_ms", "view_ms_p95", "setup_s"}
    tr = {"units": 2, "window_s": 1.0, "busy_s": 0.5, "launches": 10,
          "by_name": {"k": 0.5}, "op_device_s": {},
          "idle_gaps": [("aten::copy_", 0.25)]}
    r = run.result_line(c, dict(out, trace=tr, counters={"k1_launches": 2},
                                walk=None, unit_s=0.01, n_live=5),
                        True, dict(dev))
    assert list(r)[-1] == "checks" and "breakdown" in r
    assert set(r["metrics"]) == {"device_idle.serve",
                                 "launches_per_view.serve"}
    assert r["device"]["busy_s"] == 0.5
    assert r["breakdown"]["idle_gaps"] == [["aten::copy_", 0.25]]
    json.dumps(r)


# ----------------------------------------------------------------------
# faults planted under a tiny run on the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    rng = np.random.RandomState(0)
    n = 300
    path = tmp_path_factory.mktemp("scene") / "tiny.npz"
    np.savez(path, xyz=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
             scaling=np.full((n, 2), np.log(0.05), np.float32),
             opacity=np.full((n, 1), 1.0, np.float32))
    return path


def tiny_cell(workload, path):
    c = cells.cell(BENCHJ, workload)
    cfg = dict(c["config"], scene=str(path), gaussian_capacity=512,
               node_num=32)
    tf = dict(c["traffic"], height=48, width=48, views=12)
    return dict(c, config=cfg, traffic=tf)


def run_tiny(cell):
    out = drive.RUNNERS[cell["traffic"]["kind"]](
        cell, 2 ** 31 + 12345, 0.5, False, torch.device("cpu"), 0.0)
    return compare.judge(out["numbers"], cell["limits"])


@pytest.mark.parametrize("workload", ["node-train", "hash-train",
                                      "node-serve"])
def test_sound_tiny_run_is_correct(workload, tiny_scene):
    ok, checks = run_tiny(tiny_cell(workload, tiny_scene))
    assert ok, checks


def test_fault_state_unchanged(tiny_scene, monkeypatch):
    import d2dgs_torch.train.trainer as T
    monkeypatch.setattr(T, "adam_update", lambda g, s, p, lr: s)
    ok, checks = run_tiny(tiny_cell("node-train", tiny_scene))
    assert not ok and checks["update_gap"]["value"] >= 0.99


def test_fault_half_the_batch(tiny_scene, monkeypatch):
    import d2dgs_torch.train.trainer as T
    half = lambda a, b: torch.mean(torch.abs(a[: a.shape[0] // 2]
                                             - b[: b.shape[0] // 2]))
    monkeypatch.setattr(T, "l1", half)
    ok, checks = run_tiny(tiny_cell("node-train", tiny_scene))
    assert not ok and checks["loss_gap"]["value"] > \
        checks["loss_gap"]["limit"]


def test_fault_answer_altered(tiny_scene, monkeypatch):
    import d2dgs_torch.eval.render_sets as R
    real = R.render_view

    def altered(*a, **k):
        out = real(*a, **k)
        img = out.image.clone()
        img[5, 7, 1] = (img[5, 7, 1] + 0.5) % 1.0
        return out._replace(image=img)
    monkeypatch.setattr(R, "render_view", altered)
    ok, checks = run_tiny(tiny_cell("node-serve", tiny_scene))
    assert not ok, checks
