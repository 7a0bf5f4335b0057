"""Closed-loop serving: one client sends a request, waits for its waveform,
and sends the next, for the whole window.

A request is ``batch`` prompts of ``prompt_seconds`` of audio (drawn from
the seed: 0.05 x N(0, 1), every sample valid) with ``text_tokens`` GPT2
ids each (uniform over the vocabulary), served by the program's entry
point ``build_synthesize_pipelined(cfg)(params, audio, mask, text_ids,
generator)`` with a generator seeded per request. The client holds
``pool`` distinct requests on the host and sends them in turn, each with
noise of its own; the program copies each to the card, as a caller's
arrays would be.

Mix parameters: batch, prompt_seconds, text_tokens, pool, check_requests
(requests of the window that the comparison samples), trace_requests
(requests in each traced phase).
"""

from __future__ import annotations

import random
import time

from .. import core


def _pipe(cell) -> dict:
    return cell.config["pipeline"]


def setup(run):
    """Weights, the client's requests, the entry point and a warm-up
    request at the cell's shapes."""
    import torch
    from ditto_tts_tpu_torch.config import PipelineConfig
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize_pipelined)
    from ditto_tts_tpu_torch.params import GeneratorParams, generator_spec
    import json

    mix, dev = run.cell.mix, run.device
    pcfg = PipelineConfig.from_json(json.dumps(_pipe(run.cell)))
    spec = generator_spec(pcfg)
    spec["gpt2"] = {"wte": spec["gpt2"]["wte"]}      # serving reads wte only
    tree = core.draw_spec(torch, spec, core.subseed(run.seed, "weights"), dev)
    run.tree = tree
    run.params = GeneratorParams(**tree)
    b, samples = mix["batch"], int(mix["prompt_seconds"]
                                   * pcfg.audio.sample_rate)
    gen = torch.Generator(device=dev).manual_seed(
        core.subseed(run.seed, "requests"))
    run.requests = []
    for _ in range(mix["pool"]):
        audio = 0.05 * torch.randn((b, 1, samples), generator=gen, device=dev)
        text = torch.randint(0, run.cell.config["gpt2"]["vocab_size"], (b, mix["text_tokens"]),
                             generator=gen, device=dev)
        run.requests.append((audio.cpu(), torch.ones((b, samples),
                                                     dtype=torch.int32),
                             text.cpu()))
    run.serve = build_synthesize_pipelined(pcfg, device=dev)
    run.stages = build_stage_fns(pcfg, ref_compat=pcfg.dit.ref_compat)
    run.pcfg = pcfg
    _request(run, 0)
    run.sync()


def _noise_seed(run, i: int) -> int:
    return core.subseed(run.seed, f"noise{i}")


def _request(run, i: int):
    import torch
    audio, mask, text = run.requests[i % len(run.requests)]
    gen = torch.Generator(device=run.device).manual_seed(_noise_seed(run, i))
    return run.serve(run.params, audio, mask, text, gen)


def window(run, seconds: float):
    """Requests back to back until ``seconds`` have passed; the window
    ends when the last one's waveform is ready."""
    outs = []
    t0 = time.perf_counter()
    while True:
        outs.append(_request(run, len(outs)))
        run.sync()
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    run.outputs = outs
    sr = run.pcfg.audio.sample_rate
    run.window = {"requests": len(outs), "wall_s": wall,
                  "audio_s": sum(o.shape[0] * o.shape[-1] for o in outs) / sr}


def _staged(run, i: int, spans=None):
    """Request i through the program's stages (they compose to the entry
    point bit for bit), with each stage's output; ``spans`` adds each
    stage's synchronized seconds."""
    import torch
    audio, mask, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, mask, text = audio.to(dev), mask.to(dev), text.to(dev)
    gen = torch.Generator(device=dev).manual_seed(_noise_seed(run, i))
    st, p = run.stages, run.params
    out = {}
    steps = (("encode", lambda: st["encode"](p, audio, mask)),
             ("sampler", lambda: st["sampler"](p, out["encode"], text, gen)),
             ("vq_indices", lambda: st["vq_indices"](p, out["sampler"])),
             ("codec_decode", lambda: st["codec_decode"](
                 p, out["vq_indices"], audio.shape[-1])),
             ("mel", lambda: st["mel"](p, out["codec_decode"])),
             ("vocoder", lambda: st["vocoder"](p, out["mel"])))
    with torch.inference_mode():
        for name, fn in steps:
            t0 = time.perf_counter()
            out[name] = fn()
            if spans is not None:
                run.sync()
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
    return {"refined": out["sampler"], "indices": out["vq_indices"],
            "codec_wav": out["codec_decode"], "mel": out["mel"],
            "wave": out["vocoder"]}


def traced(run, profile):
    """Three phases of ``trace_requests`` requests each: the entry point
    timed (the work a second; ``window``), the stages with a synchronized
    span each, and the entry point under the profiler."""
    n = run.cell.mix["trace_requests"]
    t0 = time.perf_counter()
    run.outputs = []
    for i in range(n):
        run.outputs.append(_request(run, i))
        run.sync()
    run.window = {"requests": n, "wall_s": time.perf_counter() - t0,
                  "audio_s": sum(o.shape[0] * o.shape[-1]
                                 for o in run.outputs)
                  / run.pcfg.audio.sample_rate}
    spans = {}
    for i in range(n):
        _staged(run, i, spans)
    run.spans = {k: v / n for k, v in spans.items()}
    run.trace_requests = n
    run.trace = profile(lambda: [(_request(run, i), run.sync())
                                 for i in range(n)])


def check(run, checks):
    """The comparison: ``check_requests`` requests of the window, drawn
    from the seed, each through the program's stages again (held to the
    waveform the window served, bit for bit) and every stage judged
    against the reference."""
    import torch
    from ..reference import serve as ref
    pipe = _pipe(run.cell)
    rng = random.Random(core.subseed(run.seed, "check"))
    n = len(run.outputs)
    picks = sorted(rng.sample(range(n), min(run.cell.mix["check_requests"],
                                            n)))
    for i in picks:
        out = _staged(run, i)
        checks.add("stages_vs_served", float(
            (out["wave"].float() - run.outputs[i].float()).abs().max()))
        text = run.requests[i % len(run.requests)][2].to(run.device)
        run.outputs[i] = None
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        for k, v in ref.judge(run.tree, pipe, text, _noise_seed(run, i),
                              out).items():
            checks.add(k, v)
    return len(picks)


def work(run) -> dict:
    """A request's work, counted from the configuration's shapes: the
    least seconds of its model operations at each part's stated precision
    (``model_s``), and its attention and fused act->conv calls as
    (flops, bytes, dtype)."""
    from ..work import act_conv, codec, dit, vocoder
    from ..work.peaks import peak_flops
    pipe, mix = _pipe(run.cell), run.cell.mix
    prec = {k: v.split("+")[0] for k, v in run.cell.config["precision"].items()}
    d, c, v = pipe["dit"], pipe["codec"], pipe["vocoder"]
    b = mix["batch"]
    samples = int(mix["prompt_seconds"] * pipe["audio"]["sample_rate"])
    t = min(codec.frames(c, samples), d["max_token_length"])
    st = dit.text_tokens(d, mix["text_tokens"])
    f = codec.mel_frames(v, samples)
    steps = pipe["sampler"]["num_steps"]
    blocks, other = dit.step_flops(d, b, t, st)
    model_s = (steps * (blocks / peak_flops(prec["dit_blocks"])
                        + other / peak_flops(prec["dit_other"]))
               + dit.request_flops(d, b, st) / peak_flops(prec["dit_blocks"])
               + codec.encode_flops(c, b, samples) / peak_flops(prec["codec"])
               + codec.vq_flops(b, t, d["hidden_dim"],
                                pipe["nac"]["codebook_size"])
               / peak_flops(prec["vq"])
               + codec.decode_flops(c, b, t) / peak_flops(prec["codec"])
               + codec.mel_flops(v, b, samples) / peak_flops(prec["mel"])
               + vocoder.flops(v, b, f) / peak_flops(prec["vocoder"]))
    adt = d["compute_dtype"]
    return {"model_s": model_s,
            "attention": [(fl, nb, adt) for fl, nb in
                          dit.attention_calls(d, b, t, st)] * steps,
            "act_conv": [(fl, nb, v["compute_dtype"])
                         for fl, nb in act_conv.calls(v, b, f)]}


def control(run) -> dict:
    """The control's numbers for the request ``check`` judged first: the
    whole chain computed by the reference one precision below each part's
    stated one, put in the program's place and judged by the same
    comparison."""
    from ..reference import precision, serve as ref
    rng = random.Random(core.subseed(run.seed, "check"))
    i = sorted(rng.sample(range(len(run.outputs)),
                          min(run.cell.mix["check_requests"],
                              len(run.outputs))))[0]
    audio, _, text = run.requests[i % len(run.requests)]
    text = text.to(run.device)
    pipe = _pipe(run.cell)
    out = ref.chain(run.tree, pipe, text, _noise_seed(run, i),
                    audio.shape[-1],
                    precision.controls(run.cell.config["precision"]))
    return ref.judge(run.tree, pipe, text, _noise_seed(run, i), out)
