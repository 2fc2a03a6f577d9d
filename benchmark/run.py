"""Run one cell of the benchmark of the PyTorch/CUDA port of D-2DGS.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic,
its limits and its per-layer readers are found by name from
``BENCHMARK.json``.  The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, also the
last lines of standard error.  Without a CUDA device, or with JAX or
the JAX package loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# compared whole, by the top-level name of each loaded module
FORBIDDEN = ("jax", "jaxlib", "flax", "d2dgs_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def result_line(cell: dict, out: dict, trace: bool, dev: dict) -> dict:
    """The run's result: the cell's end-to-end metrics (``trace`` off) or
    the per-layer readers' (on), the device, the breakdown of a traced
    run and, last, each compared number beside its limit."""
    from benchlib import cells, compare, tracing
    if trace:
        ctx = dict(out, cfg=cell["config"], traffic=cell["traffic"])
        metrics = {}
        for m in cell["per_layer"]:
            v = cells.reader(cell["metrics_dir"], m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    ok, checks = compare.judge(out["numbers"], cell["limits"])
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = tracing.breakdown(out["trace"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = REPO / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(REPO)]
    import torch
    from benchlib import cells, drive

    bench = cells.load_benchmark(REPO / "BENCHMARK.json")
    cell = cells.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # one process, one host thread of CPU tensor work: steadier times
    torch.set_num_threads(1)
    # the configurations' precision: float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    out = drive.RUNNERS[cell["traffic"]["kind"]](
        cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": out["peak"],
           "power_limit": power_limit()}
    return report(cell, out, bool(args.trace), dev)


def report(cell: dict, out: dict, trace: bool, dev: dict) -> int:
    """Build the result (the readers are loaded here), then, with nothing
    left to load, refuse it if JAX or the JAX package is in the process;
    else print the compared numbers and the result line."""
    result = result_line(cell, out, trace, dev)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    info = {k: v for k, v in out["numbers"].items() if k.startswith("_")}
    print(f"compared: {json.dumps(info)}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)
