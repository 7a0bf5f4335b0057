"""The port's spans (``ditto_tts_tpu_torch/utils/profiling.py``) on the
CPU at tiny widths: off, ``span`` is one shared object that reads no clock
and opens no profiler range; on, the served chains and the train steps
record their stages and phases as a tree under one root with one request
id; recording changes no result bit; a span holds the profiler's host
events of the work inside it (the two share a clock); ``trace`` writes the
Chrome trace and the spans.
"""

import dataclasses
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import (AudioConfig, ByT5Config, CodecConfig,
                                        DiTConfig, GPT2Config, NACConfig,
                                        PipelineConfig, SamplerConfig,
                                        SLPConfig, VocoderConfig)
from ditto_tts_tpu_torch.diffusion.sampler import ddim_sample, ddpm_sample
from ditto_tts_tpu_torch.infer import generator as gen_mod
from ditto_tts_tpu_torch.infer import step_graph
from ditto_tts_tpu_torch.infer.generator import (build_synthesize_pipelined,
                                                 build_synthesize_recorded,
                                                 build_synthesize_with_slp)
from ditto_tts_tpu_torch.models import dit as dit_mod
from ditto_tts_tpu_torch.train import steps as tsteps
from ditto_tts_tpu_torch.utils import profiling
from ditto_tts_tpu_torch.utils.profiling import recording, span, trace

HID, K, B, L = 12, 4, 2, 256
CODEC = CodecConfig(num_filters=4, dimension=8, ratios=(2, 2, 2),
                    codebook_size=16, num_quantizers=4, lstm_layers=1)
CFG = PipelineConfig(
    audio=AudioConfig(), codec=CODEC,
    nac=NACConfig(hidden_size=HID, codebook_size=16),
    slp=SLPConfig(embedding_dim=16, num_layers=1, num_heads=1),
    dit=DiTConfig(hidden_dim=HID, num_layers=1, num_heads=2, time_dim=8,
                  text_dim=HID, diffusion_steps=10, max_token_length=64),
    vocoder=VocoderConfig(num_mels=8, upsample_rates=(2, 2, 2),
                          upsample_kernel_sizes=(4, 4, 4),
                          upsample_initial_channel=16,
                          resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),),
                          n_fft=16, hop_size=8, win_size=16),
    sampler=SamplerConfig(num_steps=K))
GPT2 = GPT2Config(vocab_size=32, n_positions=64, n_embd=HID, n_layer=1,
                  n_head=2)
BYT5 = ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32, num_layers=1,
                  num_heads=2)
SERVED = ["request", "encode", "sampler", *["sampler.step"] * K, "vq",
          "codec_decode", "mel", "vocoder"]
PHASES = ["train.step", "train.place", "train.encode", "train.forward",
          "train.backward", "train.optimizer"]


@pytest.fixture(scope="module")
def params():
    p = tparams.init_generator_params(CFG, 0, gpt2_cfg=GPT2)
    return dataclasses.replace(
        p, **tparams.init_slp_params(CFG, seed=1, byt5_cfg=BYT5))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    return (audio, np.ones((B, L), np.int32),
            rng.integers(0, GPT2.vocab_size, (B, 9)),
            rng.integers(3, BYT5.vocab_size, (B, 9)), np.ones((B, 9)))


def _serve(entry, params):
    """One request through ``entry``; the waveform."""
    audio, mask, text, bids, bmask = _inputs()
    gen = torch.Generator().manual_seed(5)
    if entry in ("ddpm", "ddim"):
        fn = build_synthesize_pipelined(CFG, sampler_kind=entry,
                                        device="cpu")
        return fn(params, audio, mask, text, gen)
    if entry == "slp":
        fn = build_synthesize_with_slp(CFG, byt5_cfg=BYT5, device="cpu")
        return fn(params, audio, mask, text, bids, bmask, gen)[0]
    g = torch.Generator().manual_seed(5)
    shape = (B, L // CODEC.hop_length, HID)
    noise = [torch.randn(shape, generator=g) for _ in range(K + 2)]
    fn = build_synthesize_recorded(CFG, return_intermediates=False,
                                   device="cpu")
    return fn(params, audio, mask, text, noise[0], noise[1],
              torch.stack(noise[2:]))


def _train(kind, params):
    """The state after one step of ``kind`` from a fresh state."""
    rng = np.random.default_rng(1)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    text = rng.integers(0, GPT2.vocab_size, (B, 9))
    if kind.startswith("ditto"):
        init, step, _ = tsteps.build_ditto_train_step(
            CFG.dit, CODEC, GPT2, learning_rate=1e-3, device="cpu")
        state = init(params.dit)
        frozen = {"codec": params.codec, "gpt2": {"wte": params.gpt2["wte"]},
                  "embedding_head": params.embedding_head}
        batch = {"audio": audio, "padding_mask": np.ones((B, L), np.int32),
                 "text_ids": text}
        if kind == "ditto_latents":
            batch = {"latents": rng.standard_normal(
                (B, L // CODEC.hop_length, HID)).astype(np.float32),
                "text_ids": text}
    elif kind == "nac":
        init, step, _ = tsteps.build_nac_train_step(
            CFG.nac, CODEC, GPT2, learning_rate=1e-3, device="cpu")
        state = tparams.init_nac_train_state(CFG.nac, 0, device="cpu")
        frozen = tparams.init_nac_frozen(CODEC, GPT2, 0, device="cpu")
        t = L // CODEC.hop_length            # the NAC reads a text a frame
        batch = {"audio": audio,
                 "text_ids": rng.integers(0, GPT2.vocab_size, (B, t)),
                 "text_mask": np.ones((B, t), np.int32)}
    else:
        init, step, _ = tsteps.build_slp_train_step(
            CFG.slp, CODEC, BYT5, learning_rate=1e-3, device="cpu")
        state = tparams.init_slp_train_state(CFG.slp, CODEC.codebook_size,
                                             0, device="cpu")
        frozen = tparams.init_slp_frozen(CODEC, BYT5, 0, device="cpu")
        batch = {"audio": audio, "text_ids": rng.integers(3, 40, (B, 9)),
                 "text_mask": np.ones((B, 9), np.int32),
                 "label": np.asarray([0, 3], np.int32)}
    new, _ = step(state, frozen, batch, torch.Generator().manual_seed(2))
    return new


def _names_under(spans, root):
    """The names of the spans under ``root`` (its index), in order, each
    with the depth below it."""
    depth = {root: 0}
    out = []
    for i, s in enumerate(spans):
        if s["parent"] in depth:
            depth[i] = depth[s["parent"]] + 1
            out.append((s["name"], depth[i]))
    return out


class _Boom:
    def time_ns(self):
        raise AssertionError("the clock was read with recording off")


def test_off_span_is_one_shared_object_that_reads_no_clock(params,
                                                           monkeypatch):
    """With recording off a whole request runs through ``span`` with no
    span object made, no clock read and no profiler range opened."""
    def refuse(*a, **k):
        raise AssertionError("made with recording off")

    monkeypatch.setattr(profiling, "time", _Boom())
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("request", batch=2) is profiling.OFF
    assert span("sampler.step", step=0) is span("vq")
    with span("vq") as got:
        assert got is None
    wave = _serve("ddpm", params)
    assert torch.isfinite(wave).all() and profiling._recorder is None


@pytest.mark.parametrize("entry", ["ddpm", "ddim", "recorded", "slp"])
def test_served_request_records_its_stages(params, entry):
    with recording() as rec:
        _serve(entry, params)
    spans = rec.spans()
    assert spans[0]["name"] == "request" and spans[0]["parent"] is None
    frames = 64 if entry == "slp" else L // CODEC.hop_length
    assert spans[0]["attrs"] == {"batch": B, "frames": frames}
    want = [n if n != "encode" else ("slp" if entry == "slp" else n)
            for n in SERVED]
    assert [s["name"] for s in spans] == want
    under = _names_under(spans, 0)
    assert all(d == (2 if n == "sampler.step" else 1) for n, d in under)
    assert {s["request"] for s in spans} == {0}
    steps = [s for s in spans if s["name"] == "sampler.step"]
    sampler = spans.index(next(s for s in spans if s["name"] == "sampler"))
    assert [s["attrs"]["step"] for s in steps] == list(range(K))
    assert all(s["parent"] == sampler for s in steps)
    assert spans[sampler]["attrs"] == {"batch": B, "frames": frames,
                                       "steps": K, "graph": "eager",
                                       "glue": "eager"}
    for i, s in enumerate(spans):
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
        if i:
            assert spans[i - 1]["start_ns"] <= s["start_ns"]


def test_requests_take_one_id_each(params):
    fn = build_synthesize_pipelined(CFG, device="cpu")
    audio, mask, text, _, _ = _inputs()
    with recording() as rec:
        for seed in range(3):
            fn(params, audio, mask, text, torch.Generator().manual_seed(seed))
    spans = rec.spans()
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["request"] * 3
    assert [s["request"] for s in spans] == \
        [0] * len(SERVED) + [1] * len(SERVED) + [2] * len(SERVED)


@pytest.mark.parametrize("kind", ["ditto_audio", "ditto_latents", "nac",
                                  "slp"])
def test_train_step_records_its_phases(params, kind):
    with recording() as rec:
        _train(kind, params)
    spans = rec.spans()
    want = PHASES if kind.startswith("ditto") else \
        [p for p in PHASES if p != "train.encode"]
    assert [s["name"] for s in spans] == want
    assert spans[0]["parent"] is None
    assert all(s["parent"] == 0 and s["request"] == 0 for s in spans[1:])


@pytest.mark.parametrize("what", ["ddpm", "slp", "ditto_audio", "nac"])
def test_recording_changes_no_result_bit(params, what):
    run = _train if what in ("ditto_audio", "nac") else _serve
    off = run(what, params)
    with recording() as rec:
        on = run(what, params)
    assert rec.spans()
    a = [t for _, t in tparams.tree_leaves(off)] if isinstance(off, dict) \
        else [off]
    b = [t for _, t in tparams.tree_leaves(on)] if isinstance(on, dict) \
        else [on]
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _abs_ns(results, t):
    """A Kineto event's time in Unix-epoch ns (some builds stamp events
    relative to the trace's start)."""
    start = results.trace_start_ns()
    return t if t >= start else t + start


def test_span_holds_the_profilers_host_events_of_its_work():
    """The profiler stamps host events on the clock spans read: the ops run
    inside a span, and the range the span opens, lie within its
    [start_ns, end_ns]."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with recording() as rec, torch.profiler.profile(activities=acts) as prof:
        with span("outer"):
            torch.ones(64).sum()
            with span("inner"):
                torch.arange(8.0).mul(2)
    spans = {s["name"]: s for s in rec.spans()}
    results = prof.profiler.kineto_results
    seen = set()
    for e in results.events():
        holder = {"aten::ones": "outer", "aten::sum": "outer",
                  "aten::arange": "inner", "aten::mul": "inner",
                  "outer": "outer", "inner": "inner"}.get(e.name())
        if holder is None:
            continue
        s = spans[holder]
        assert s["start_ns"] <= _abs_ns(results, e.start_ns()) \
            <= _abs_ns(results, e.end_ns()) <= s["end_ns"], e.name()
        seen.add(e.name())
    assert {"outer", "inner", "aten::sum", "aten::mul"} <= seen


def test_trace_writes_the_chrome_trace_and_the_spans(params, tmp_path):
    with trace(str(tmp_path)) as rec:
        _serve("ddpm", params)
    assert isinstance(rec, profiling.Recorder)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(SERVED) <= names
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [s["name"] for s in spans] == SERVED
    assert spans == rec.spans()
    assert profiling._recorder is None


def _worker():
    with span("worker"):
        pass


def test_threads_keep_their_own_stacks_and_recordings_restore():
    with recording() as outer:
        with span("main") as got:
            assert got is None
            t = threading.Thread(target=_worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with recording() as inner:
                with span("nested"):
                    pass
            with span("child"):
                pass
    assert [s["name"] for s in inner.spans()] == ["nested"]
    got = {s["name"]: s for s in outer.spans()}
    assert set(got) == {"main", "worker", "child"}
    assert got["worker"]["parent"] is None and got["worker"]["request"] == 1
    assert got["child"]["parent"] == 0 and got["child"]["request"] == 0
    assert profiling._recorder is None


def test_annotate_adds_to_the_innermost_open_span_of_its_name():
    """What a callee decides lands on its caller's span: the innermost open
    one of the name, on this thread only; nothing when recording is off,
    no such span is open, or it has closed."""
    profiling.annotate("sampler", glue="off")
    seen = []

    def other_thread():
        with span("sampler", where="thread"):
            seen.append(1)

    with recording() as rec:
        profiling.annotate("sampler", glue="none open")
        with span("sampler", steps=2):
            with span("sampler", steps=1):
                with span("sampler.step"):
                    profiling.annotate("sampler", glue="fused")
                    profiling.annotate("absent", glue="eager")
            profiling.annotate("sampler", graph="eager")
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=30)
        profiling.annotate("sampler", glue="closed")
    assert seen == [1]
    assert [(s["name"], s["attrs"]) for s in rec.spans()] == [
        ("sampler", {"steps": 2, "graph": "eager"}),
        ("sampler", {"steps": 1, "glue": "fused"}),
        ("sampler.step", {}),
        ("sampler", {"where": "thread"})]


@pytest.mark.parametrize("entry", ["ddpm", "ddim", "recorded", "slp"])
def test_cpu_sampler_records_glue_eager(params, entry):
    """On the CPU the DiT forward runs the eager block stack and says so on
    the ``sampler`` span."""
    with recording() as rec:
        _serve(entry, params)
    assert [s["attrs"]["glue"] for s in rec.spans()
            if s["name"] == "sampler"] == ["eager"]


def _no_capture(*a, **k):
    raise AssertionError("the step was captured")


@pytest.mark.parametrize("entry", ["ddpm", "ddim", "recorded", "slp"])
def test_cpu_sampler_records_eager_and_no_capture(params, entry,
                                                  monkeypatch):
    """On the CPU the step is never graphed: the ``sampler`` span says
    ``graph="eager"`` and no ``sampler.capture`` span opens."""
    monkeypatch.setattr(step_graph, "capture", _no_capture)
    with recording() as rec:
        _serve(entry, params)
    spans = rec.spans()
    assert [s["attrs"]["graph"] for s in spans
            if s["name"] == "sampler"] == ["eager"]
    assert "sampler.capture" not in {s["name"] for s in spans}


@pytest.mark.parametrize("on_cuda", [False, True], ids=["cpu", "cuda"])
@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_step_graph_engages_on_a_cuda_tensor_with_grad_off(monkeypatch,
                                                          mode, on_cuda):
    """The graph engages for a CUDA x with grad mode off, and never under
    grad (a stand-in reports ``is_cuda`` here, where there is no card)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    x = SimpleNamespace(is_cuda=True) if on_cuda else torch.zeros(2)
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    with ctx():
        assert step_graph.engages(x) == (on_cuda and mode != "grad")


def test_step_graph_stays_out_of_a_capture_under_way(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with torch.inference_mode():
        assert not step_graph.engages(SimpleNamespace(is_cuda=True))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_cpu_sample_is_the_plain_sampler_loop(params, monkeypatch, kind,
                                              grad):
    """``_sample`` on the CPU, with grad mode off or on, is the sampler over
    a plain ``model_fn`` around ``ditto_forward``, bit for bit."""
    monkeypatch.setattr(step_graph, "capture", _no_capture)
    cfg = CFG
    schedule, taus = gen_mod._schedule(cfg, None)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((B, 16, HID), generator=g)
    emb = torch.randn((B, 9, HID), generator=g)
    with torch.set_grad_enabled(grad):
        got = gen_mod._sample(params, cfg, schedule, taus, x, emb,
                              kind=kind,
                              generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        prep = dit_mod.prepare(params.dit, cfg.dit, emb, x.shape[1])

        def model_fn(xx, t):
            return dit_mod.ditto_forward(params.dit, cfg.dit, xx, emb, t,
                                         prepared=prep)

        kw = dict(generator=torch.Generator().manual_seed(4),
                  clip_denoised=cfg.sampler.clip_denoised,
                  prediction_type=cfg.dit.prediction_type)
        want = (ddim_sample(model_fn, x, schedule, taus,
                            eta=cfg.sampler.ddim_eta, **kw)
                if kind == "ddim" else
                ddpm_sample(model_fn, x, schedule, taus, **kw))
    assert got.dtype == want.dtype and torch.equal(got.detach(), want)
