"""The plain reference against the port on the CPU at a tiny size, with
the port's precisions set to fp32 so that the two differ by rounding
alone: every stage of the serving chain (the fused act->conv edges
included) and the first steps of training. With the configuration's own
precisions the control (the reference one precision lower) reads
further from the reference than the port does."""

import time

import pytest
import torch


from benchmark.tests import tiny
from benchmark.tests.test_bench_schema import _run_mod

FP32_SERVE = {"stages_vs_served": 0.0, "refined_rel": 1e-5, "vq_excess": 0.0,
              "codec_rel": 1e-5, "mel_rel": 1e-5, "wave_rel": 1e-5}
TRAIN_MIX = {"kind": "train_step", "batch": 2, "audio_seconds": 0.25,
             "text_ids": 32, "pool": 4, "check_steps": 3, "trace_steps": 1}
TRAIN_LIMITS = {"loss_rel": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-3}


def fp32_config(name):
    cfg = tiny.tiny_config(name)
    cfg["pipeline"]["sampler"]["num_steps"] = 50
    cfg["pipeline"]["dit"]["compute_dtype"] = "float32"
    cfg["pipeline"]["vocoder"].update(compute_dtype="float32",
                                      carry_dtype="float32")
    return cfg


@pytest.mark.parametrize("name", ["ditto-base", "ditto-ref"])
def test_serving_chain_matches_the_port(tmp_path, name):
    cell = tiny.cell(tmp_path, config=fp32_config(name), limits=FP32_SERVE)
    result, lines, _ = _run_mod().run_cell(
        cell, 3, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], lines


def test_training_steps_match_the_port(tmp_path):
    cell = tiny.cell(tmp_path, config=fp32_config("ditto-base"),
                     mix=TRAIN_MIX, limits=TRAIN_LIMITS, name="tiny-train")
    result, lines, run = _run_mod().run_cell(
        cell, 4, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], lines
    assert len(run.losses) == 3


@pytest.mark.parametrize("seed", [1, 2])
def test_control_reads_further_than_the_port(tmp_path, seed):
    cfg = tiny.tiny_config("ditto-base")
    cfg["pipeline"]["sampler"]["num_steps"] = 50
    cell = tiny.cell(tmp_path, config=cfg)
    result, _, run = _run_mod().run_cell(
        cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter())
    prog = {k: v["value"] for k, v in result["checks"].items()}
    ctrl = run.traffic.control(run)
    for k in ("refined_rel", "codec_rel", "mel_rel", "wave_rel"):
        assert ctrl[k] > prog[k], (k, ctrl[k], prog[k])
