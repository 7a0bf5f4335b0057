"""The comparison catches the faults a cell can have (``benchmark/faults``):
the run's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, with the program broken underneath, and
``correct`` comes out false. One card, so no exchange between cards to
leave out."""

import time

import pytest
import torch

from benchmark import faults
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import (FP32_SERVE, TRAIN_LIMITS,
                                                  TRAIN_MIX, fp32_config)
from benchmark.tests.test_bench_schema import _run_mod


@pytest.mark.parametrize("name", sorted(faults.SERVING))
def test_serving_fault_is_not_correct(tmp_path, name):
    cell = tiny.cell(tmp_path, config=fp32_config("ditto-base"),
                     limits=FP32_SERVE)
    with faults.SERVING[name]():
        result, lines, _ = _run_mod().run_cell(
            cell, 9, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], lines


@pytest.mark.parametrize("name", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(tmp_path, name):
    cell = tiny.cell(tmp_path, config=fp32_config("ditto-base"),
                     mix=TRAIN_MIX, limits=TRAIN_LIMITS, name="tiny-train")
    with faults.TRAINING[name]():
        result, lines, _ = _run_mod().run_cell(
            cell, 10, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], lines


def test_faults_are_removed_afterwards():
    from ditto_tts_tpu_torch.codec import rvq
    real = rvq.vq_indices
    with faults.alter_code():
        assert rvq.vq_indices is not real
    assert rvq.vq_indices is real
