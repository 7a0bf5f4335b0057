"""Closed-loop F5-TTS synthesis: one client sends a request, waits for its
waveform, and sends the next, for the whole window.

A request is ``batch`` rows, each a prompt of ``prompt_seconds`` (drawn
from the seed: 0.05 x N(0, 1), every sample valid) and ``text_tokens``
character ids (uniform over the configuration's vocabulary), served by the
program's entry point ``build_synthesize_pipelined(cfg)(params, audio,
mask, text_ids, generator)`` for an ``F5PipelineConfig``: F5's fixed
duration in all, the frames after the prompt generated and returned. The
client holds ``pool`` distinct requests on the host and sends them in
turn, each with noise of its own; the program copies each to the card.
The window's audio is the generated seconds returned.

Mix parameters: batch, prompt_seconds, text_tokens, pool, check_requests
(requests of the window that the comparison samples), trace_requests
(requests in each traced phase).
"""

from __future__ import annotations

import json
import random
import time

from .. import core


def _pipe(cell) -> dict:
    return cell.config["pipeline"]


def setup(run):
    """Weights, the client's requests, the entry point and a warm-up
    request at the cell's shapes."""
    import torch
    from ditto_tts_tpu_torch.config import F5PipelineConfig
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize_pipelined)
    from ditto_tts_tpu_torch.params import F5Params, f5_spec

    mix, dev = run.cell.mix, run.device
    pcfg = F5PipelineConfig.from_json(json.dumps(_pipe(run.cell)))
    tree = core.draw_spec(torch, f5_spec(pcfg),
                          core.subseed(run.seed, "weights"), dev)
    run.tree = tree
    run.params = F5Params(**tree)
    b = mix["batch"]
    samples = int(mix["prompt_seconds"] * pcfg.vocoder.sampling_rate)
    gen = torch.Generator(device=dev).manual_seed(
        core.subseed(run.seed, "requests"))
    run.requests = []
    for _ in range(mix["pool"]):
        audio = 0.05 * torch.randn((b, 1, samples), generator=gen,
                                   device=dev)
        text = torch.randint(0, pcfg.dit.text_num_embeds,
                             (b, mix["text_tokens"]), generator=gen,
                             device=dev)
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
        / run.pcfg.vocoder.sampling_rate


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


def _staged(run, i: int, spans=None):
    """Request i through the program's stages (they compose to the entry
    point bit for bit), with each stage's output; ``spans`` adds each
    stage's synchronized seconds."""
    import torch
    audio, _, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, text = audio.to(dev), text.to(dev)
    gen = torch.Generator(device=dev).manual_seed(_noise_seed(run, i))
    st, p, n = run.stages, run.params, run.pcfg.total_frames
    out = {}
    steps = (("mel", lambda: st["mel"](p, audio)),
             ("text_encode", lambda: st["text_encode"](p, text, n)),
             ("sampler", lambda: st["sampler"](p, out["mel"][0],
                                               out["text_encode"], gen)),
             ("vocoder", lambda: st["vocoder"](
                 p, out["sampler"][:, out["mel"][0].shape[1]:]
                 .transpose(1, 2))))
    with torch.inference_mode():
        for name, fn in steps:
            t0 = time.perf_counter()
            out[name] = fn()
            if spans is not None:
                run.sync()
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
        wave = st["loudness"](out["vocoder"], out["mel"][1])
    return {"cond": out["mel"][0], "text2": out["text_encode"],
            "mel": out["sampler"], "wave": wave}


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
    from the seed, each through the program's stages again (held to the
    waveform the window served, bit for bit) and every stage judged
    against the reference (``_judge``)."""
    import torch
    for i in _picks(run):
        out = _staged(run, i)
        checks.add("stages_vs_served", float(
            (out["wave"].float() - run.outputs[i].float()).abs().max()))
        run.outputs[i] = None
        if run.device.type == "cuda":
            torch.cuda.empty_cache()

        def program_velocity(y, t, out=out):
            with torch.inference_mode():
                return run.stages["velocity"](
                    run.params, out["cond"], out["text2"], y,
                    torch.full((y.shape[0],), t, device=y.device))

        for k, v in _judge(run, i, out, program_velocity).items():
            checks.add(k, v)


def _judge(run, i: int, out: dict, velocity_at) -> dict:
    """The numbers compared for request i, whose stage outputs are ``out``
    (cond [B, P, mel], mel [B, N, mel], wave [B, L']) and whose judged
    velocity is ``velocity_at(y, t)``: each stage against the fp32
    reference applied to the judged side's own previous output.

      mel_rel       the prompt's log-mel, from the prompt's audio;
      flow_rel      the sampled mel, from the judged cond, the text and
                    the request's y0;
      velocity_rel  one guided velocity at the reference trajectory's
                    state before the middle step (the request's own x_t);
      wave_rel      BigVGAN on the judged generated frames, scaled back.
    """
    import torch
    from ..reference import f5 as ref
    from ..reference import codec as codec_ref
    from ..reference import vocoder as voc_ref
    from ..reference.precision import exact
    from ..work import act_conv as act_conv_work
    pipe, tree = _pipe(run.cell), run.tree
    fp32 = {"blocks": "float32", "carry": "float32", "other": "float32"}
    audio, _, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, text = audio.to(dev), text.to(dev)
    cond, mel, wave = out["cond"], out["mel"], out["wave"]
    b, n, m = mel.shape
    gen = torch.Generator(device=dev).manual_seed(_noise_seed(run, i))
    y0 = torch.randn((b, n, m), generator=gen, dtype=torch.float32,
                     device=dev)
    mid = pipe["sampler"]["steps"] // 2
    with torch.inference_mode(), exact():
        rms, gain = ref.prompt_gain(audio, pipe["sampler"]["target_rms"])
        want = codec_ref.log_mel(pipe["vocoder"], audio[:, 0] * gain[:, None],
                                 "float32").transpose(1, 2)
        nums = {"mel_rel": core.rel_rms(cond, want)}
        flow, y_mid = ref.flow(tree, pipe["dit"], pipe["sampler"], cond,
                               text, y0, fp32, record_at=mid)
        nums["flow_rel"] = core.rel_rms(mel, flow)
        del flow
        t_mid = float(ref.times(pipe["sampler"])[mid])
        v_want = ref.velocity(tree, pipe["dit"], pipe["sampler"], cond, text,
                              y_mid, t_mid, fp32)
        nums["velocity_rel"] = core.rel_rms(velocity_at(y_mid, t_mid),
                                            v_want)
        del v_want, y_mid
        gen_mel = mel[:, cond.shape[1]:].transpose(1, 2)
        voc = pipe["vocoder"]
        fused = [w for w, _ in act_conv_work.fused_stage_widths(
            voc, gen_mel.shape[-1])]
        w = voc_ref.forward(tree["vocoder"], voc, gen_mel, "float32", fused)
        target = pipe["sampler"]["target_rms"]
        w = torch.where((rms < target)[:, None], w * (rms / target)[:, None],
                        w)
        nums["wave_rel"] = core.rel_rms(wave, w)
    return nums


def control(run) -> dict:
    """The control's numbers for the request ``check`` judged first: the
    whole chain computed by the reference one precision below each part's
    stated one, put in the program's place and judged by the same
    comparison."""
    import torch
    from ..reference import codec as codec_ref
    from ..reference import f5 as ref
    from ..reference import precision
    from ..reference import vocoder as voc_ref
    from ..work import act_conv as act_conv_work
    i = _picks(run)[0]
    pipe = _pipe(run.cell)
    low = precision.controls(run.cell.config["precision"])
    prec = {"blocks": low["dit_blocks"], "carry": low["dit_carry"],
            "other": low["dit_other"]}
    audio, _, text = run.requests[i % len(run.requests)]
    dev = run.device
    audio, text = audio.to(dev), text.to(dev)
    b, n, m = audio.shape[0], run.pcfg.total_frames, pipe["dit"]["mel_dim"]
    gen = torch.Generator(device=dev).manual_seed(_noise_seed(run, i))
    y0 = torch.randn((b, n, m), generator=gen, dtype=torch.float32,
                     device=dev)
    with torch.inference_mode(), precision.exact():
        rms, gain = ref.prompt_gain(audio, pipe["sampler"]["target_rms"])
        cond = codec_ref.log_mel(pipe["vocoder"], audio[:, 0] * gain[:, None],
                                 low["mel"]).transpose(1, 2)
        mel = ref.flow(run.tree, pipe["dit"], pipe["sampler"], cond, text,
                       y0, prec)
        gen_mel = mel[:, cond.shape[1]:].transpose(1, 2)
        voc = pipe["vocoder"]
        fused = [w for w, _ in act_conv_work.fused_stage_widths(
            voc, gen_mel.shape[-1])]
        wave = voc_ref.forward(run.tree["vocoder"], voc, gen_mel,
                               low["vocoder"], fused)
        target = pipe["sampler"]["target_rms"]
        wave = torch.where((rms < target)[:, None],
                           wave * (rms / target)[:, None], wave)

    def control_velocity(y, t):
        with torch.inference_mode(), precision.exact():
            return ref.velocity(run.tree, pipe["dit"], pipe["sampler"], cond,
                                text, y, t, prec)

    return _judge(run, i, {"cond": cond, "mel": mel, "wave": wave},
                  control_velocity)


def work(run) -> dict:
    """A request's work, counted from the configuration's shapes
    (``benchmark.work.f5``): the least seconds of its model operations at
    each part's stated precision (``model_s``), and its attention calls and
    its vocoder's fused act->conv calls as (flops, bytes, dtype)."""
    from ..work import act_conv, codec, f5, vocoder
    from ..work.peaks import peak_flops
    pipe, mix = _pipe(run.cell), run.cell.mix
    prec = {k: v.split("+")[0]
            for k, v in run.cell.config["precision"].items()}
    d, v, s = pipe["dit"], pipe["vocoder"], pipe["sampler"]
    b = mix["batch"]
    n = f5.total_frames(pipe)
    samples = int(mix["prompt_seconds"] * v["sampling_rate"])
    p = codec.mel_frames(v, samples)
    blocks, other = f5.step_flops(d, b, n)
    model_s = (s["steps"] * (blocks / peak_flops(prec["dit_blocks"])
                             + other / peak_flops(prec["dit_other"]))
               + f5.request_flops(d, b, n) / peak_flops(prec["dit_other"])
               + codec.mel_flops(v, b, samples) / peak_flops(prec["mel"])
               + vocoder.flops(v, b, n - p) / peak_flops(prec["vocoder"]))
    return {"model_s": model_s,
            "attention": [(fl, nb, d["compute_dtype"]) for fl, nb in
                          f5.attention_calls(d, b, n)] * s["steps"],
            "act_conv": [(fl, nb, v["compute_dtype"])
                         for fl, nb in act_conv.calls(v, b, n - p)]}
