"""On the card, at each cell's own size: a run of the cell is correct and
the control (the reference one precision below the configuration, in the
program's place) fails at least one of the cell's limits. Marked ``chip``;
skips where there is no CUDA card:

    python -m pytest benchmark/tests/test_bench_chip.py -m chip
"""

import time

import pytest
import torch

from benchmark import core
from benchmark.tests.test_bench_schema import _run_mod

CELLS = [w["name"] for w in core.load_benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = core.Cell(core.load_benchmark(), name)
    result, lines, run = _run_mod().run_cell(
        cell, 2**31 + 4242, 0.0, False, torch.device("cuda"),
        time.perf_counter())
    assert result["correct"], lines
    control = run.traffic.control(run)
    failed = {k: v for k, v in control.items()
              if k in cell.limits and not v <= cell.limits[k]}
    assert failed, control
