"""Cells found by name: ``BENCHMARK.json``'s workload, its configuration
file, its traffic file (``traffic/<name>.json``), its limits
(``limits/<workload>.json``) and the per-layer readers
(``metrics/<metric>.py``, each with ``read(ctx) -> float | None``).
A cell, a mix or a metric is added by adding files and entries."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: Path = REPO) -> dict:
    ws = {w["name"]: w for w in bench["workloads"]}
    if workload not in ws:
        raise KeyError(f"no workload {workload!r}; the cells are "
                       f"{sorted(ws)}")
    w = ws[workload]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    bdir = root / bench["paths"][0]
    return dict(
        workload=workload, chips=w["chips"],
        config=_json(root / c["file"]),
        traffic=_json(bdir / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bdir / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
        metrics_dir=bdir / "metrics")


def reader(metrics_dir: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmetric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
