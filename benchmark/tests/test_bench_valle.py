"""The VALL-E serving cell on the CPU at a tiny size: its work counts at the
cell's shapes, a tiny cell run through the unchanged harness (sound, with
its checks, the control worse than the program), and the traced run's
span metrics."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from benchmark.tests import tiny
from benchmark.traffic import serve_valle
from benchmark.work import valle as valle_work

BENCH = core.load_benchmark()


def _run_mod():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", core.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_valle_work_counts_at_the_cell_shapes():
    cell = core.Cell(BENCH, "serve-valle-b32-10s")
    w = serve_valle.work(SimpleNamespace(cell=cell))
    model = cell.config["pipeline"]["model"]
    # 12 prefill calls and 7 x 12 NAR calls; 750 x 12 decode launches
    assert len(w["attention"]) == 12 + 84
    assert len(w["kv_attention"]) == 9000
    # the decode's bytes: a step reads 32 x 12 x 2 x kv x 1024 x 2 B of
    # cache, 1.15 GB at the average kv of 728
    kv = [valle_work.decode_call(model, 32, 128 + 225 + i)[1]
          for i in range(750)]
    assert abs(12 * sum(kv) / 750 - 1.15e9) / 1.15e9 < 0.03
    # a NAR stage ~12.6 TFLOP with attention
    blocks, other = valle_work.flops(model, 32, 128, 225, 750)
    assert 80e12 < blocks < 110e12 and other > 0
    assert 0.05 < w["model_s"] < 0.2


def _tiny_valle(tmp_path, name="tiny-valle", eos="suppressed"):
    cfg = json.loads((core.BENCH / "configs"
                      / "valle-encodec-6kbps.json").read_text())
    pipe = cfg["pipeline"]
    pipe["model"].update(d_model=64, nhead=4, num_layers=2, ffn_dim=128,
                         num_phonemes=16, codebook_size=32,
                         compute_dtype="float32")
    pipe["codec"].update(num_filters=4, dimension=16, codebook_size=32)
    cfg["precision"].update(valle_blocks="float32", valle_carry="float32")
    mix = {"kind": "serve_valle", "batch": 2, "prompt_seconds": 0.08,
           "phonemes": 5, "generated_frames": 8, "top_k": 5,
           "temperature": 1.0, "eos": eos, "pool": 2,
           "check_requests": 1, "trace_requests": 1}
    limits = {"stages_vs_served": 0.0, "prompt_latent_rel": 1e-5,
              "prompt_codes": 0.0, "ar_logits_rel": 1e-5,
              "nar_logits_rel": 1e-5, "codec_rel": 1e-5}
    tiny.write_cell(tmp_path, config=cfg, mix=mix, limits=limits, name=name)
    return core.Cell(core.load_benchmark(tmp_path), name, bench_dir=tmp_path)


def test_a_tiny_valle_cell_runs_through_the_harness(tmp_path):
    cell = _tiny_valle(tmp_path)
    result, lines, run = _run_mod().run_cell(
        cell, 2**31 + 9, 0.0, False, torch.device("cpu"),
        time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"stages_vs_served", "prompt_latent_rel",
                                     "prompt_codes", "ar_logits_rel",
                                     "nar_logits_rel", "codec_rel"}
    assert result["checks"]["stages_vs_served"]["value"] == 0.0
    assert run.window["audio_s"] == run.window["requests"] * 2 * 8 * 320 \
        / 24000
    control = run.traffic.control(run)
    prog = {k: v["value"] for k, v in result["checks"].items()}
    for k in ("prompt_latent_rel", "ar_logits_rel", "nar_logits_rel",
              "codec_rel"):
        assert control[k] > prog[k], (k, control[k], prog[k])


def test_a_tiny_valle_cell_reports_its_spans(tmp_path):
    cell = _tiny_valle(tmp_path)
    result, _, run = _run_mod().run_cell(cell, 13, 0.0, True,
                                         torch.device("cpu"),
                                         time.perf_counter())
    got = result["metrics"]
    for m in ("mfu.valle", "ar_step_host_ms.valle"):
        assert m in got, m
    for m in ("kv_attention_roofline.valle", "attention_roofline.valle",
              "ar_share.valle", "ar_idle_share.valle", "nar_share.valle"):
        assert m not in got, m                  # no device operations
    assert set(run.spans) == {"encode", "ar", "nar", "codec_decode"}


def test_a_valle_mix_takes_eos_suppressed_only(tmp_path):
    """The program never draws EOS, so a mix that would stop at it is
    refused before any weight is drawn."""
    cell = _tiny_valle(tmp_path, eos="stops")
    with pytest.raises(ValueError, match="suppressed"):
        _run_mod().run_cell(cell, 5, 0.0, False, torch.device("cpu"),
                            time.perf_counter())
