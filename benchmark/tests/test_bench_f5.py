"""The F5 serving cell and the data-parallel training cell on the CPU at
tiny sizes: F5's work counts and the mix's frame arithmetic, a tiny F5
cell run through the unchanged harness (sound, with its checks), and
``train_dp`` over two gloo ranks: the ranks run the steps rank 0 decides
and stop when it says, each on its own rows of the global batch, and the
comparison passes."""

import copy
import json
import time

import pytest
import torch

from benchmark import core
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import TRAIN_LIMITS, fp32_config
from benchmark.traffic import train_dp
from benchmark.work import attention, f5 as f5_work

BENCH = core.load_benchmark()


def _run_mod():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", core.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f5_config():
    return json.loads((core.BENCH / "configs" / "f5-v1-base.json").read_text())


def test_f5_work_counts_and_the_frame_arithmetic():
    cfg = _f5_config()
    pipe = cfg["pipeline"]
    cell = core.Cell(BENCH, "serve-f5-b4-25s")
    n = f5_work.total_frames(pipe)
    assert n == 2343 == int(25 * 24000 / 256)
    from benchmark.work import codec
    p = codec.mel_frames(pipe["vocoder"], 10 * 24000)
    assert p == 937
    # 15 s generated a row: (2343 - 937) frames of 256 samples
    assert abs((n - p) * 256 / 24000 - 15.0) < 256 / 24000
    d = pipe["dit"]
    calls = f5_work.attention_calls(d, cell.mix["batch"], n)
    assert len(calls) == 22
    assert calls[0] == attention.call(8, 16, n, n, 64, "bfloat16")
    att = 22 * 4.0 * 8 * 16 * n * n * 64
    assert abs(att - 3.96e12) / 3.96e12 < 0.01
    blocks, other = f5_work.step_flops(d, cell.mix["batch"], n)
    dense = 2 * (3 * 1024 ** 2 + 1024 ** 2 + 2 * 1024 * 2048) * 22 * 8 * n
    assert abs(dense - 6.9e12) / 6.9e12 < 0.01
    assert blocks > att + dense and other > 0
    assert f5_work.request_flops(d, 4, n) > 0


def test_f5_and_dp4_work_count_the_kernels_their_traces_time():
    """Each request's 54 act->conv pairs over F5's 1,406 generated frames;
    rank 0's 48 attention calls a dp4 step (self and cross per layer, the
    forward and its recompute: kernel A's launches a step)."""
    from types import SimpleNamespace
    from benchmark.traffic import serve_f5
    from benchmark.work import act_conv, dit
    f5 = core.Cell(BENCH, "serve-f5-b4-25s")
    w = serve_f5.work(SimpleNamespace(cell=f5))
    voc = f5.config["pipeline"]["vocoder"]
    assert len(w["act_conv"]) == 54
    assert [c[:2] for c in w["act_conv"]] == act_conv.calls(voc, 4, 1406)
    assert {c[2] for c in w["act_conv"]} == {voc["compute_dtype"]}
    dp = core.Cell(BENCH, "train-base-dp4")
    w = train_dp.work(SimpleNamespace(cell=dp))
    d = dp.config["pipeline"]["dit"]
    assert len(w["attention"]) == 48
    assert [c[:2] for c in w["attention"][:24]] == \
        dit.attention_calls(d, 32, 750, 750)
    assert w["attention"][:24] == w["attention"][24:]


def _tiny_f5(tmp_path, name="tiny-f5"):
    cfg = _f5_config()
    pipe = cfg["pipeline"]
    pipe["dit"].update(dim=64, depth=2, heads=4, dim_head=16, text_dim=32,
                       text_num_embeds=40, conv_layers=1, conv_pos_groups=4,
                       time_freq_dim=32)
    pipe["sampler"].update(steps=3, fix_duration=0.5)
    pipe["vocoder"].update(upsample_initial_channel=192,
                           compute_dtype="float32", carry_dtype="float32")
    pipe["dit"]["compute_dtype"] = "float32"
    mix = {"kind": "serve_f5", "batch": 2, "prompt_seconds": 0.2,
           "text_tokens": 7, "pool": 2, "check_requests": 1,
           "trace_requests": 1}
    limits = {"stages_vs_served": 0.0, "velocity_rel": 1e-5,
              "flow_rel": 1e-5, "mel_rel": 1e-5, "wave_rel": 1e-5}
    tiny.write_cell(tmp_path, config=cfg, mix=mix, limits=limits, name=name)
    return core.Cell(core.load_benchmark(tmp_path), name, bench_dir=tmp_path)


def test_a_tiny_f5_cell_runs_through_the_harness(tmp_path):
    cell = _tiny_f5(tmp_path)
    result, lines, run = _run_mod().run_cell(
        cell, 2**31 + 5, 0.0, False, torch.device("cpu"),
        time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"stages_vs_served", "velocity_rel",
                                     "flow_rel", "mel_rel", "wave_rel"}
    assert result["checks"]["stages_vs_served"]["value"] == 0.0
    # the generated seconds a row: (46 - 18) frames of 256 samples
    assert run.window["audio_s"] == run.window["requests"] * 2 * 28 * 256 \
        / 24000
    control = run.traffic.control(run)
    prog = {k: v["value"] for k, v in result["checks"].items()}
    for k in ("velocity_rel", "flow_rel", "mel_rel", "wave_rel"):
        assert control[k] > prog[k], (k, control[k], prog[k])


def test_a_tiny_f5_cell_reports_its_spans(tmp_path):
    cell = _tiny_f5(tmp_path)
    result, _, _ = _run_mod().run_cell(cell, 11, 0.0, True,
                                       torch.device("cpu"),
                                       time.perf_counter())
    got = result["metrics"]
    for m in ("mfu.f5", "step_host_ms.f5", "text_encode_ms.f5",
              "sampler_s.f5", "vocoder_s.f5"):
        assert m in got, m
    for m in ("attention_share.f5", "act_conv_roofline.f5"):
        assert m not in got, m                  # no device operations


def _tiny_dp(tmp_path, name="tiny-dp"):
    cfg = fp32_config("ditto-base")
    cfg["train"] = copy.deepcopy(json.loads(
        (core.BENCH / "configs" / "ditto-base.json").read_text())["train"])
    cfg["gpt2"]["n_positions"] = 1024
    mix = {"kind": "train_dp", "ranks": 2, "batch_per_rank": 2,
           "audio_seconds": 0.1, "text_ids": 16, "pool": 2, "check_steps": 2,
           "trace_steps": 1, "check_rows": 2}
    tiny.write_cell(tmp_path, config=cfg, mix=mix, limits=TRAIN_LIMITS,
                    name=name)
    return core.Cell(core.load_benchmark(tmp_path), name, bench_dir=tmp_path)


def test_train_dp_ranks_follow_rank_0_and_split_the_batch(tmp_path):
    cell = _tiny_dp(tmp_path)
    result, _, run = _run_mod().run_cell(
        cell, 2**33 + 1, 0.5, False, torch.device("cpu"),
        time.perf_counter())
    steps = run.window["requests"] + cell.mix["check_steps"]
    assert run.rank_steps == (steps, steps)
    assert all(p.returncode == 0 for p in run.workers or [])
    assert result["correct"], result["checks"]
    assert run.window["audio_s"] == run.window["requests"] * 2 * 2 * 0.1
    # rank r's rows are rows [r b, (r + 1) b) of the global batch
    glob = train_dp.global_batches(run, 2)
    for r in range(2):
        mine = train_dp._rank_batches(run, r, 2)
        for i in range(2):
            for k in mine[i]:
                assert (glob[i][k][2 * r:2 * r + 2] == mine[i][k]).all()
    assert not (glob[0]["audio"][:2] == glob[0]["audio"][2:]).all()


@pytest.mark.parametrize("seconds", [0.0])
def test_train_dp_traced_run_reads_the_allreduce_span(tmp_path, seconds):
    cell = _tiny_dp(tmp_path)
    result, _, run = _run_mod().run_cell(
        cell, 7, seconds, True, torch.device("cpu"), time.perf_counter())
    got = result["metrics"]
    assert "mfu.dp4" in got and "backward_host_ms.dp4" in got
    for m in ("backward_idle_share.dp4", "attention_roofline.dp4"):
        assert m not in got, m                  # no device operations
    names = {s["name"] for s in run.program_spans["host"]}
    assert "train.allreduce" in names
    steps = run.window["requests"] + cell.mix["check_steps"] + 2 * \
        cell.mix["trace_steps"] + cell.mix["trace_steps"]
    assert run.rank_steps == (steps, steps)
