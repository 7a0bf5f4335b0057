"""The VALL-E serving chain (arXiv:2301.02111; ``models/valle.py``):

  EnCodec encode of the prompt (8 codebooks at 6 kbps) -> the AR prefill
  over [text; the prompt's first codebook but its last frame] into a KV
  cache -> the AR decode, one token a row a step from the prompt's last
  frame on, top-k from the request's generator, for ``generated_frames``
  steps -> the NAR stages 2..8 (argmax) -> EnCodec decode of the generated
  frames' 8 codebooks.

``build_synthesize_pipelined`` and ``build_stage_fns`` in
``infer/generator.py`` reach this module for a ``VallePipelineConfig``,
with the same call as the other chains: fn(params, audio, padding_mask,
text_ids, generator) -> waveform [B, generated_frames x hop]. ``params``
is a ``params.ValleParams``; ``text_ids`` are phoneme ids [B, T]; the
prompts share one length.

The decode step on the card: where ``step_graph.engages``, one step (the
token's embedding at a device-side position, the 12 layers with their K
and V appended to the cache, A's decode launch over it, the logits, the
top-k draw and the position's advance) is captured once a request
(``ar.capture``) and replayed for every token; its state is device
tensors alone (the last token, the position, from which the key length
and the draw's offset follow, and the request's seed, drawn from the
generator once). A shape new to the process runs one eager step first,
which is the request's step 0. Elsewhere (the CPU, grad mode) the same
step runs eagerly, so the replayed loop gives the eager loop's tokens.

Spans: ``request`` over ``encode``, ``ar`` (batch, steps, graph) over
``ar.prefill``, ``ar.capture`` and ``ar.step`` (step) a token, ``nar``
over ``nar.stage`` (stage), and ``codec_decode``; counters
``kv_cache_bytes`` and ``ar_tokens`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..codec import encodec as codec_mod
from ..codec import rvq as rvq_mod
from ..codec import seanet
from ..config import VallePipelineConfig
from ..models import valle as valle_mod
from ..utils.profiling import annotate, count, span
from . import step_graph
from .kv_cache import KVCache


def _decoder(cfg: VallePipelineConfig, params, text_ids, prompt_c1,
             generator, logits: bool):
    """(whether the step is graphed, run(), tokens [B, N], logits [B, N, V]
    or None): the AR decode of a request set up over a prefilled cache;
    ``run()`` decodes every token."""
    m, s = cfg.model, cfg.sampler
    dev = text_ids.device
    b, t = text_ids.shape
    p, n = prompt_c1.shape[1], s.generated_frames
    cache = KVCache(m.num_layers, b, m.nhead, t + p + n - 1, m.head_dim,
                    getattr(torch, m.compute_dtype), dev)
    count("kv_cache_bytes", cache.nbytes)
    pe = valle_mod.sine_pe(max(t, p + n), m.d_model, dev)
    layers = valle_mod.prepare(params.ar, m)
    with span("ar.prefill"):
        valle_mod.ar_prefill(params.ar, layers, m, text_ids,
                             prompt_c1[:, :p - 1], cache, pe)
    tok = prompt_c1[:, p - 1].clone()
    apos = torch.full((1,), p - 1, dtype=torch.int64, device=dev)
    seed = torch.randint(0, 1 << 32, (2,), generator=generator,
                         device=generator.device if generator is not None
                         else dev).to(dev)
    lanes = torch.arange(b * s.top_k, device=dev).view(b, s.top_k)
    bias = torch.zeros(m.codebook_size + 1, device=dev)
    bias[m.eos] = float("-inf")
    tokens = torch.zeros((b, n), dtype=torch.int64, device=dev)
    out = torch.zeros((b, n, m.codebook_size + 1), device=dev) \
        if logits else None

    def step():
        lg = valle_mod.ar_decode_step(params.ar, layers, m, tok, apos, t,
                                      cache, pe)
        i = apos - (p - 1)
        if out is not None:
            out.index_copy_(1, i, lg[:, None])
        nxt = valle_mod.sample_top_k(lg, seed, apos, lanes, s.top_k,
                                     s.temperature, bias)
        tokens.index_copy_(1, i, nxt[:, None])
        tok.copy_(nxt)
        apos.add_(1)

    graphed = step_graph.engages(tok)

    def run():
        first = 0
        if graphed:
            with span("ar.capture"):
                ran, replay = step_graph.capture_step(
                    step, dev, ("valle_ar", m, s, b, t, p, logits))
            first = int(ran)
        else:
            replay = step
        for i in range(n):
            with span("ar.step", step=i):
                if i >= first:
                    replay()
        count("ar_tokens", b * n)

    return graphed, run, tokens, out


def valle_stage_fns(cfg: VallePipelineConfig):
    """VALL-E's chain as stages, each a plain function; they compose to
    ``build_synthesize_pipelined(cfg)`` bit for bit:

      encode(params, audio [B, 1, L], padding_mask) -> (codes [B, 8, P],
          latents [B, dimension, P])
      ar(params, text_ids [B, T], prompt_codes, generator, logits=False)
          -> tokens [B, N] (and the logits [B, N, V] that drew them)
      nar(params, text_ids, prompt_codes, tokens, logits=False) -> codes
          [B, 8, N] (and each stage's logits [B, N, K], stages 2..8)
      codec_decode(params, codes) -> waveform [B, N x hop]
    """
    m, s = cfg.model, cfg.sampler

    def encode(params, audio, padding_mask=None):
        with span("encode"):
            if padding_mask is not None:
                audio = audio * padding_mask[:, None, :].to(audio.dtype)
            lat = seanet.encode(params.codec["encoder"], cfg.codec, audio)
            return rvq_mod.rvq_encode(params.codec["quantizer"]["codebooks"],
                                      lat, m.num_codebooks), lat

    def ar(params, text_ids, prompt_codes, generator, logits: bool = False):
        with span("ar", batch=text_ids.shape[0], steps=s.generated_frames):
            graphed, run, tokens, out = _decoder(
                cfg, params, text_ids, prompt_codes[:, 0], generator, logits)
            annotate("ar", graph="captured" if graphed else "eager")
            run()
        return (tokens, out) if logits else tokens

    def nar(params, text_ids, prompt_codes, tokens, logits: bool = False):
        b, n = tokens.shape
        codes = torch.zeros((b, m.num_codebooks, n), dtype=torch.int64,
                            device=tokens.device)
        codes[:, 0] = tokens
        pe = valle_mod.sine_pe(max(text_ids.shape[1],
                                   prompt_codes.shape[2] + n), m.d_model,
                               tokens.device)
        got = []
        with span("nar", batch=b, frames=n):
            layers = valle_mod.prepare(params.nar, m)
            for k in range(2, m.num_codebooks + 1):
                with span("nar.stage", stage=k):
                    lg = valle_mod.nar_logits(params.nar, layers, m, k,
                                              text_ids, prompt_codes, codes,
                                              pe)
                    codes[:, k - 1] = lg.argmax(dim=-1)
                if logits:
                    got.append(lg)
        return (codes, got) if logits else codes

    def codec_decode(params, codes):
        with span("codec_decode"):
            return codec_mod.codec_decode(params.codec, cfg.codec,
                                          codes)[:, 0]

    return {"encode": encode, "ar": ar, "nar": nar,
            "codec_decode": codec_decode}


def build_valle_synthesize(cfg: VallePipelineConfig, dev):
    """fn(params, audio [B, 1, L], padding_mask [B, L] or None, text_ids
    [B, T], generator) -> waveform [B, generated_frames x hop]."""
    st = valle_stage_fns(cfg)

    @torch.inference_mode()
    def synthesize(params, audio, padding_mask, text_ids,
                   generator: Optional[torch.Generator] = None):
        with span("request", batch=audio.shape[0],
                  frames=cfg.sampler.generated_frames):
            audio = torch.as_tensor(audio, dtype=torch.float32).to(dev)
            mask = None if padding_mask is None else torch.as_tensor(
                padding_mask).to(dev)
            text_ids = torch.as_tensor(text_ids, dtype=torch.int64).to(dev)
            codes, _ = st["encode"](params, audio, mask)
            tokens = st["ar"](params, text_ids, codes, generator)
            return st["codec_decode"](params, st["nar"](
                params, text_ids, codes, tokens))

    return synthesize
