"""Card tests of the comparison: at each cell's own size, the control (the
plain reference in TF32 in the port's place) reads as not correct under
the cell's limits.  They skip without a CUDA device.

    python -m pytest benchmark/tests/test_bench_card.py -q --noconftest \
        -o addopts=""
"""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import cells, compare, control  # noqa: E402

WORKLOADS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.cell(cells.load_benchmark(), workload)
    numbers = control.NUMBERS[cell["traffic"]["kind"]](
        cell, 2 ** 31 + 977, torch.device("cuda", 0))
    ok, checks = compare.judge(numbers, cell["limits"])
    assert not ok, checks
