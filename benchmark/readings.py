"""Readings the limits of ``limits/<workload>.json`` are set from, on the
card, at the cell's own size: the numbers the comparison reads for the
port (a short window per seed, each seed set up anew) and, with
``--variant tf32``, for the control (the reference in TF32 in the
port's place, ``benchlib/control.py``), ``--variant half`` for the
fault of half the batch left out, planted in the reference put in the
port's place, or ``--variant self`` for the float32 reference against
itself run again.  One JSON line per seed.

    python3 benchmark/readings.py --workload node-train --seeds 1,2,3 \
        [--seconds 2] [--variant port|tf32|half|self]
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variant", default="port",
                   choices=("port", "tf32", "half", "self"))
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch
    from benchlib import cells, control, drive
    if not torch.cuda.is_available():
        print("readings are taken on a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.cell(cells.load_benchmark(), args.workload)
    kind = cell["traffic"]["kind"]
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.variant != "port":
            numbers = control.NUMBERS[kind](cell, seed, device, args.variant)
        else:
            out = drive.RUNNERS[kind](cell, seed, args.seconds, False, device,
                                      t0)
            numbers = dict(out["numbers"], _e2e=out["e2e"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant, "numbers": numbers,
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
