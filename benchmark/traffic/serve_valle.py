"""Closed-loop VALL-E synthesis: one client sends a request, waits for its
waveform, and sends the next, for the whole window.

A request is ``batch`` rows, each a prompt of ``prompt_seconds`` (drawn
from the seed: 0.05 x N(0, 1), every sample valid) and ``phonemes``
phoneme ids (uniform over the configuration's table), served by the
program's entry point ``build_synthesize_pipelined(cfg)(params, audio,
mask, text_ids, generator)`` for a ``VallePipelineConfig``: the prompt's
EnCodec codes, ``generated_frames`` AR tokens a row drawn top-``top_k`` at
``temperature`` (``eos`` "suppressed": never drawn, so every row decodes
them all), 7 NAR stages and EnCodec decode; the generated frames'
waveform returned. The client holds ``pool`` distinct requests on the host
and sends them in turn, each with a generator seeded of its own; the
program copies each to the card. The window's audio is the generated
seconds returned.

Mix parameters: batch, prompt_seconds, phonemes, generated_frames, top_k,
temperature, eos, pool, check_requests (requests of the window that the
comparison samples), trace_requests (requests in each traced phase).
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

from .. import core

FP32 = {"blocks": "float32", "carry": "float32", "other": "float32"}


def _pipe(cell) -> dict:
    return cell.config["pipeline"]


def _model_prec(prec: dict) -> dict:
    return {"blocks": prec["valle_blocks"], "carry": prec["valle_carry"],
            "other": prec["valle_other"]}


def setup(run):
    """Weights, the client's requests, the entry point and a warm-up
    request at the cell's shapes."""
    import torch
    from ditto_tts_tpu_torch.config import (ValleSamplerConfig,
                                            VallePipelineConfig)
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize_pipelined)
    from ditto_tts_tpu_torch.params import ValleParams, valle_spec

    mix, dev = run.cell.mix, run.device
    if mix["eos"] != "suppressed":
        raise ValueError(f"eos {mix['eos']!r}: the program decodes every "
                         "row to generated_frames and never draws EOS, so "
                         "a mix takes only \"suppressed\"")
    pcfg = VallePipelineConfig.from_json(json.dumps(_pipe(run.cell)))
    pcfg = pcfg.replace(sampler=ValleSamplerConfig(
        generated_frames=mix["generated_frames"], top_k=mix["top_k"],
        temperature=mix["temperature"]))
    tree = core.draw_spec(torch, valle_spec(pcfg),
                          core.subseed(run.seed, "weights"), dev)
    run.tree = tree
    run.params = ValleParams(**tree)
    b = mix["batch"]
    samples = int(mix["prompt_seconds"] * pcfg.codec.sample_rate)
    gen = torch.Generator(device=dev).manual_seed(
        core.subseed(run.seed, "requests"))
    run.requests = []
    for _ in range(mix["pool"]):
        audio = 0.05 * torch.randn((b, 1, samples), generator=gen,
                                   device=dev)
        text = torch.randint(0, pcfg.model.num_phonemes,
                             (b, mix["phonemes"]), generator=gen, device=dev)
        run.requests.append((audio.cpu(), torch.ones((b, samples),
                                                     dtype=torch.int32),
                             text.cpu()))
    run.serve = build_synthesize_pipelined(pcfg, device=dev)
    run.stages = build_stage_fns(pcfg)
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


def _audio_s(run, outs) -> float:
    return sum(o.shape[0] * o.shape[-1] for o in outs) \
        / run.pcfg.codec.sample_rate


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
    run.outputs = outs
    run.window = {"requests": len(outs), "wall_s": time.perf_counter() - t0,
                  "audio_s": _audio_s(run, outs)}


def _staged(run, i: int, spans=None, logits: bool = False):
    """Request i through the program's stages (they compose to the entry
    point bit for bit), with each stage's output, and with ``logits`` the
    logits the AR drew from and each NAR stage's; ``spans`` adds each
    stage's synchronized seconds."""
    import torch
    audio, mask, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, mask, text = audio.to(dev), mask.to(dev), text.to(dev)
    gen = torch.Generator(device=dev).manual_seed(_noise_seed(run, i))
    st, p = run.stages, run.params
    out = {}
    steps = (("encode", lambda: st["encode"](p, audio, mask)),
             ("ar", lambda: st["ar"](p, text, out["encode"][0], gen,
                                     logits=logits)),
             ("nar", lambda: st["nar"](
                 p, text, out["encode"][0],
                 out["ar"][0] if logits else out["ar"], logits=logits)),
             ("codec_decode", lambda: st["codec_decode"](
                 p, out["nar"][0] if logits else out["nar"])))
    with torch.inference_mode():
        for name, fn in steps:
            t0 = time.perf_counter()
            out[name] = fn()
            if spans is not None:
                run.sync()
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
    res = {"codes": out["encode"][0], "latents": out["encode"][1],
           "wave": out["codec_decode"]}
    if logits:
        res.update(tokens=out["ar"][0], ar_logits=out["ar"][1],
                   generated=out["nar"][0], nar_logits=out["nar"][1])
    return res


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
                  "audio_s": _audio_s(run, run.outputs)}
    spans = {}
    for i in range(n):
        _staged(run, i, spans)
    run.spans = {k: v / n for k, v in spans.items()}
    run.trace_requests = n
    run.trace = profile(lambda: [(_request(run, i), run.sync())
                                 for i in range(n)])


def _picks(run):
    rng = random.Random(core.subseed(run.seed, "check"))
    n = len(run.outputs)
    return sorted(rng.sample(range(n), min(run.cell.mix["check_requests"],
                                           n)))


def check(run, checks):
    """The comparison: ``check_requests`` requests of the window, drawn
    from the seed, each through the program's stages again (its waveform
    held to the one the window served, bit for bit: equal only where every
    AR token and NAR code is) and every stage judged against the
    reference (``_judge``)."""
    import torch
    for i in _picks(run):
        out = _staged(run, i, logits=True)
        checks.add("stages_vs_served", float(
            (out["wave"].float() - run.outputs[i].float()).abs().max()))
        run.outputs[i] = None
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        for k, v in _judge(run, i, out).items():
            checks.add(k, v)


def rvq_excess(codebooks, lat, codes) -> float:
    """How far any chosen code's squared distance (in float64) to its
    stage's residual lies above the nearest code's, beyond what fp32
    rounding of the port's expression (the largest 2 x.c - |c|^2, the
    residual less each chosen code in fp32) can account for, as a share of
    how far the median code's lies above the nearest; the largest over
    frames and the 8 stages, each stage's residual left by the judged
    side's own earlier choices. 0 for every choice the stated fp32
    arithmetic could make (``reference.serve.vq_excess``'s rule, with
    |x|^2 in the allowance for the residual's rounding)."""
    import torch
    from ..reference import codec as codec_ref
    x = lat.transpose(1, 2).reshape(-1, lat.shape[1]).double()
    ulp = (x.shape[-1] + 2 + codes.shape[1]) * 2.0 ** -24
    worst = 0.0
    for q in range(codes.shape[1]):
        cb = codebooks[q].double()
        d = codec_ref.sq_distances(x, cb, dtype=torch.float64)
        mag = 2.0 * (x.abs() @ cb.abs().t()) + cb.square().sum(-1)[None] \
            + x.square().sum(-1, keepdim=True)
        best, at = d.min(-1)
        spread = (d.median(-1).values - best).clamp(min=1e-300)
        k = codes[:, q].reshape(-1, 1).long()
        chosen = d.gather(1, k)[:, 0]
        allow = ulp * (mag.gather(1, k)[:, 0] + mag.gather(1, at[:, None])[:, 0])
        worst = max(worst, float(((chosen - best - allow).clamp(min=0)
                                  / spread).max()))
        x = x - cb[k[:, 0]]
    return worst


def _judge(run, i: int, out: dict) -> dict:
    """The numbers compared for request i, whose stage outputs are ``out``
    (latents [B, 128, P] and codes [B, 8, P] of the prompt, tokens [B, N]
    and the logits that drew them, the generated codes [B, 8, N] and each
    NAR stage's logits, wave [B, L]): each stage against the fp32
    reference applied to the judged side's own previous output.

      prompt_latent_rel  the prompt's EnCodec latents;
      prompt_codes       the prompt's 8 codebooks (``rvq_excess``);
      ar_logits_rel      every decoded position's logits against the AR's
                         full masked forward, teacher-forced on the prompt's
                         first codebook and the drawn tokens;
      nar_logits_rel     the largest over the 7 stages, each given the
                         judged side's earlier codebooks;
      codec_rel          EnCodec decode of the generated codes.
    """
    import torch
    from ..reference import codec as codec_ref
    from ..reference import valle as ref
    from ..reference.precision import exact
    pipe, tree = _pipe(run.cell), run.tree
    model = dataclasses.asdict(run.pcfg.model)
    audio, _, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, text = audio.to(dev), text.to(dev)
    codes, gen = out["codes"], out["generated"]
    cbs = tree["codec"]["quantizer"]["codebooks"]
    with torch.inference_mode(), exact():
        lat = codec_ref.encode(tree["codec"]["encoder"], pipe["codec"], audio,
                               "float32")
        nums = {"prompt_latent_rel": core.rel_rms(out["latents"], lat),
                "prompt_codes": rvq_excess(cbs, out["latents"], codes)}
        del lat
        want = ref.decoded_logits(tree["ar"], model, text, codes[:, 0],
                                  out["tokens"], FP32)
        nums["ar_logits_rel"] = core.rel_rms(out["ar_logits"], want)
        del want
        nums["nar_logits_rel"] = max(
            core.rel_rms(lg, ref.nar_logits(tree["nar"], model, k, text,
                                            codes, gen, FP32))
            for k, lg in zip(range(2, 9), out["nar_logits"]))
        z = codec_ref.rvq_decode(cbs, gen)
        w = codec_ref.decode(tree["codec"]["decoder"], pipe["codec"], z,
                             "float32", out["wave"].shape[-1])[:, 0]
        nums["codec_rel"] = core.rel_rms(out["wave"], w)
    return nums


def control(run) -> dict:
    """The control's numbers for the request ``check`` judged first: each
    stage computed by the reference one precision below the stated one
    (the prompt's encode and codes, the AR's logits on the program's
    tokens, the NAR stages' on the program's codes, the decode of them),
    put in the program's place and judged by the same comparison."""
    import torch
    from ..reference import codec as codec_ref
    from ..reference import precision
    from ..reference import valle as ref
    i = _picks(run)[0]
    prog = _staged(run, i, logits=True)
    pipe, tree = _pipe(run.cell), run.tree
    model = dataclasses.asdict(run.pcfg.model)
    low = precision.controls(run.cell.config["precision"])
    prec = _model_prec(low)
    audio, _, text = run.requests[i % len(run.requests)]
    audio, text = audio.to(run.device), text.to(run.device)
    cbs = tree["codec"]["quantizer"]["codebooks"]
    with torch.inference_mode(), precision.exact():
        lat = codec_ref.encode(tree["codec"]["encoder"], pipe["codec"], audio,
                               low["codec"])
        codes = codec_ref.rvq_encode(cbs, lat, model["num_codebooks"],
                                     low["vq"])
        gen = prog["generated"]
        out = {"latents": lat, "codes": codes, "tokens": prog["tokens"],
               "generated": gen,
               "ar_logits": ref.decoded_logits(tree["ar"], model, text,
                                               codes[:, 0], prog["tokens"],
                                               prec),
               "nar_logits": [ref.nar_logits(tree["nar"], model, k, text,
                                             codes, gen, prec)
                              for k in range(2, 9)]}
        z = codec_ref.rvq_decode(cbs, gen)
        out["wave"] = codec_ref.decode(tree["codec"]["decoder"],
                                       pipe["codec"], z, low["codec"],
                                       prog["wave"].shape[-1])[:, 0]
    return _judge(run, i, out)


def work(run) -> dict:
    """A request's work, counted from the configuration's shapes
    (``benchmark.work.valle``): the least seconds of its model operations
    at each part's stated precision (``model_s``), its kernel-A calls (the
    prefill's and the NAR's) and its decode launches as (flops, bytes,
    dtype)."""
    from ..work import codec, valle
    from ..work.peaks import peak_flops
    mix = run.cell.mix
    pipe = _pipe(run.cell)
    prec = {k: v.split("+")[0]
            for k, v in run.cell.config["precision"].items()}
    model, c = pipe["model"], pipe["codec"]
    b, t, n = mix["batch"], mix["phonemes"], mix["generated_frames"]
    samples = int(mix["prompt_seconds"] * c["sample_rate"])
    p = codec.frames(c, samples)
    blocks, other = valle.flops(model, b, t, p, n)
    nq = model["num_codebooks"]
    model_s = (blocks / peak_flops(prec["valle_blocks"])
               + other / peak_flops(prec["valle_other"])
               + codec.encode_flops(c, b, samples, nq)
               / peak_flops(prec["codec"])
               + codec.decode_flops(c, b, n) / peak_flops(prec["codec"]))
    dt = model["compute_dtype"]
    return {"model_s": model_s,
            "attention": [(fl, nb, dt) for fl, nb in
                          valle.attention_calls(model, b, t, p, n)],
            "kv_attention": [(fl, nb, dt) for fl, nb in
                             valle.decode_calls(model, b, t, p, n)]}
