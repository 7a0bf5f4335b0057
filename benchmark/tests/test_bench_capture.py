"""The capture of the sampler's CUDA graph as the benchmark reads it
(``metrics/capture_host_ms.py``): the mean host ms of the program's
``sampler.capture`` span, and nothing from a program that records none
(the eager sampler, or a program before the graph)."""

from types import SimpleNamespace

import pytest

from benchmark.metrics import capture_host_ms
from benchmark.tests.test_bench_spans import _run_with, _span, _timeline


def test_capture_host_ms_reads_the_capture_span_where_there_is_one():
    run = _run_with(_timeline())
    assert capture_host_ms.read(run) is None
    run.program_spans["host"] += [_span("sampler.capture", 100, 1100, 1),
                                  _span("sampler.capture", 2000, 5000, 1)]
    assert capture_host_ms.read(run) == pytest.approx(2000 / 1e6)
    assert capture_host_ms.read(SimpleNamespace(program_spans=None)) is None
