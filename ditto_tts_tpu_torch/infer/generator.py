"""The DiTTo serving chains (the JAX ``infer/generator.py``).

  codec encode -> embedding head -> truncate to max_token_length frames ->
  channel mean -> q_sample at t=T-1 -> K-step DDPM or DDIM over the DiT,
  conditioned on GPT2 wte text embeddings -> repeat to 2 codebook channels
  -> VectorQuantizer indices -> codec decode -> mel -> BigVGAN -> waveform.

``build_synthesize_pipelined`` is the serving entry point: the two halves
of the JAX two-dispatch split (``refine_indices``, ``indices_to_waveform``)
run back to back on one stream with no host round-trip.
``build_synthesize``, the JAX one-jit entry point, returns the same
function. Noise comes from a
``torch.Generator`` on the device, drawn as the JAX key split orders it:
the prompt noise, x_init, then the sampler's per-step draws.
``build_synthesize_recorded`` takes that noise explicitly and returns the
intermediates, for parity runs. ``build_stage_fns`` exposes the stages for
timing. ``build_synthesize_with_slp`` serves the SLP-driven chain: the SLP
predicts each utterance's frames, the DiT denoises a max-length buffer and
the frames past the prediction are zeroed (quirk #5 corrected);
``build_slp_stage_fns`` exposes its stages.

Given an ``F5PipelineConfig``, ``build_synthesize_pipelined`` and
``build_stage_fns`` serve F5-TTS (``models/f5.py``) with the same call:
the prompt RMS-normalised up to the target (F5's inference), its log-mel,
the text embedding, the flow sampler (``diffusion/flow.py``) from y0 ~
N(0, I) over ``total_frames`` with the prompt's mel as the condition and
classifier-free guidance in one batch of 2B rows, the prompt's frames
put back, BigVGAN over the frames after the prompt, and the waveform
scaled back by the prompt's gain. ``params`` is a ``params.F5Params``;
``text_ids`` are F5's character ids (-1 pads); prompts share one length
(a padding mask, where given, marks every sample valid).

Given a ``VallePipelineConfig``, the same two entry points serve VALL-E
(``infer/valle.py``: EnCodec encode, the AR over a KV cache with a graphed
decode step, the NAR stages, EnCodec decode).

Entry points run on ``cuda`` unless built with ``device="cpu"``; inputs are
moved to that device, and the parameters must already be there.

Spans (``utils/profiling.py``, recorded inside a ``recording()`` block): a
request is ``request`` (attrs batch, frames) over ``encode`` or ``slp``,
``sampler`` (batch, frames, steps, graph: "captured" or "eager") over
``sampler.capture`` (where the step is graphed, ``step_graph.py``) and one
``sampler.step`` a step, ``vq``, ``codec_decode``, ``mel`` and
``vocoder``; each sits in the function the entry points and the stage
functions share. The F5 request is ``request`` over ``mel``,
``text_encode``, ``sampler`` (``sampler.capture``, ``sampler.step``) and
``vocoder``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..codec import encodec as codec_mod
from ..codec import rvq as rvq_mod
from ..config import (ByT5Config, F5PipelineConfig, PipelineConfig,
                      VallePipelineConfig, byt5_small_config)
from ..diffusion.flow import euler_sample, sway_times
from ..diffusion.sampler import ddim_sample, ddpm_sample, respaced_timesteps
from ..diffusion.schedule import NoiseSchedule, q_sample
from ..models import dit as dit_mod
from ..models import f5 as f5_mod
from ..models import nac as nac_mod
from ..models import slp as slp_mod
from ..models import vocoder as voc_mod
from ..ops.mel import get_mel_spectrogram
from ..params import GeneratorParams
from ..text import gpt2 as gpt2_mod
from ..utils.profiling import span
from . import step_graph
from .valle import build_valle_synthesize, valle_stage_fns


def encode_prompt_latents(params: GeneratorParams, cfg: PipelineConfig,
                          audio, padding_mask=None):
    """Waveform -> channel-meaned latents [B, T <= max_token_length, H]."""
    with span("encode"):
        latents, _ = nac_mod.audio_encoder(
            {"embedding_head": params.embedding_head}, params.codec,
            cfg.codec, audio, padding_mask)                # [B, nq, T, H]
        return latents[:, :, :cfg.dit.max_token_length].mean(dim=1)


def _codec_decode(params: GeneratorParams, cfg: PipelineConfig, indices,
                  output_length: int):
    with span("codec_decode"):
        return codec_mod.codec_decode(params.codec, cfg.codec, indices,
                                      output_length=output_length)


def _mel(cfg: PipelineConfig, wav):
    v = cfg.vocoder
    with span("mel"):
        return get_mel_spectrogram(
            wav, sample_rate=v.sampling_rate, n_fft=v.n_fft,
            num_mels=v.num_mels, hop=v.hop_size, win_size=v.win_size,
            fmin=v.fmin, fmax=v.fmax)


def _vocode(params: GeneratorParams, cfg: PipelineConfig, mel):
    with span("vocoder"):
        return voc_mod.bigvgan_forward(params.vocoder, cfg.vocoder, mel)[:, 0]


def _frames(cfg: PipelineConfig, samples: int) -> int:
    """The latent frames a prompt of ``samples`` gives the DiT."""
    return min(-(-samples // cfg.codec.hop_length), cfg.dit.max_token_length)


def refined_to_indices(params: GeneratorParams, refined, *,
                       ref_exact: bool = False):
    """Refined latents [B, T, H] -> VQ indices [B, 2, T] (quirk #8: the
    latents are repeated to the 2 codebook channels)."""
    with span("vq"):
        stacked = refined[:, None].expand(-1, 2, -1, -1)
        return rvq_mod.vq_indices(params.vector_quantizer, stacked,
                                  ref_exact=ref_exact)


def indices_to_waveform(params: GeneratorParams, cfg: PipelineConfig,
                        indices, output_length: int, *,
                        return_intermediates: bool = False):
    """VQ indices -> codec decode -> mel -> BigVGAN waveform [B, L']."""
    wav = _codec_decode(params, cfg, indices, output_length)
    mel = _mel(cfg, wav[:, 0])
    out = _vocode(params, cfg, mel)
    if return_intermediates:
        return out, {"codec_wav": wav, "mel": mel}
    return out


def latents_to_waveform(params: GeneratorParams, cfg: PipelineConfig,
                        latents, output_length: int, *,
                        ref_exact_vq: bool = False):
    """Refined latents [B, T, H] -> waveform [B, L'] (quirk #9: codec
    decode to audio, re-analyze to mel, re-render)."""
    indices = refined_to_indices(params, latents, ref_exact=ref_exact_vq)
    return indices_to_waveform(params, cfg, indices, output_length)


def _schedule(cfg: PipelineConfig, num_steps: Optional[int]):
    steps = cfg.sampler.num_steps if num_steps is None else num_steps
    return (NoiseSchedule.cosine(cfg.dit.diffusion_steps),
            respaced_timesteps(cfg.dit.diffusion_steps, steps))


@contextlib.contextmanager
def _sampling(x, steps: int):
    """The ``sampler`` span of a sampler starting from ``x`` [B, N, ...];
    yields ``graph(model_fn, t0, key)``. Where ``step_graph.engages(x)``,
    ``graph`` captures ``model_fn`` under ``sampler.capture`` (``t0()``
    makes the first step's t; ``key`` as ``step_graph.capture`` takes it)
    and returns the replaying ``model_fn``; elsewhere it returns
    ``model_fn`` itself."""
    graphed = step_graph.engages(x)

    def graph(model_fn, t0, key):
        if not graphed:
            return model_fn
        with span("sampler.capture"):
            return step_graph.capture(model_fn, x, t0(), key)

    with span("sampler", batch=x.shape[0], frames=x.shape[1], steps=steps,
              graph="captured" if graphed else "eager"):
        yield graph


def _sample(params, cfg: PipelineConfig, schedule, taus, x_init, text_emb,
            *, kind: str = "ddpm", generator=None, noise_seq=None,
            clip: bool = True):
    """The sampler over the DiT; ``clip`` applies ``cfg.sampler.clip_denoised``
    (the recorded form passes False: JAX's reference-parity path has no
    clip). Where ``step_graph.engages`` (a CUDA x, grad mode off), the DiT
    forward of a step is captured once, after ``prepare``, and replayed
    for every step; the updates and the draws stay eager, in their order."""
    with _sampling(x_init, len(taus)) as graph:
        prep = dit_mod.prepare(params.dit, cfg.dit, text_emb,
                               x_init.shape[1])

        def model_fn(x, t):
            return dit_mod.ditto_forward(params.dit, cfg.dit, x, text_emb, t,
                                         prepared=prep)

        model_fn = graph(
            model_fn, lambda: torch.full((x_init.shape[0],), int(taus[0]),
                                         dtype=torch.int64,
                                         device=x_init.device),
            (cfg.dit, tuple(text_emb.shape), text_emb.dtype))
        common = dict(noise_seq=noise_seq, generator=generator,
                      clip_denoised=cfg.sampler.clip_denoised if clip
                      else None, prediction_type=cfg.dit.prediction_type)
        if kind == "ddim":
            return ddim_sample(model_fn, x_init, schedule, taus,
                               eta=cfg.sampler.ddim_eta, **common)
        if kind != "ddpm":
            raise ValueError(f"unknown sampler kind {kind!r}")
        return ddpm_sample(model_fn, x_init, schedule, taus, **common)


def _text_emb(params, cfg: PipelineConfig, text_ids):
    return gpt2_mod.embed_tokens(params.gpt2,
                                 text_ids[:, :cfg.dit.max_token_length])


def _denoiser(cfg: PipelineConfig, *, num_steps: Optional[int],
              kind: str, cond_by_audio: bool, compat: bool):
    """fn(params, latents, text_ids, generator) -> refined latents: the
    prompt noise, x_init, then the sampler's draws from the generator
    (JAX ``generator.py:250-287``); cond_by_audio starts from the noised
    prompt, ref_compat noises it with the reference's schedule."""
    schedule, taus = _schedule(cfg, num_steps)

    def denoise(params, latents, text_ids, generator):
        def draw():
            return torch.randn(latents.shape, generator=generator,
                               dtype=latents.dtype, device=latents.device)

        prompt_noise, x_init = draw(), draw()
        if cond_by_audio:
            t_full = torch.full((latents.shape[0],),
                                cfg.dit.diffusion_steps - 1,
                                dtype=torch.int64)
            x_init = q_sample(schedule, latents, t_full, prompt_noise,
                              ref_compat=compat)
        return _sample(params, cfg, schedule, taus, x_init,
                       _text_emb(params, cfg, text_ids), kind=kind,
                       generator=generator)

    return denoise


def build_stage_fns(cfg: PipelineConfig, *, num_steps: Optional[int] = None,
                    sampler_kind: Optional[str] = None,
                    cond_by_audio: bool = False,
                    ref_compat: bool = False):
    """The chain split into stages, each a plain function for timing:
    encode, sampler, vq_indices, codec_decode, mel, vocoder, and the two
    halves of the serving path (refine_indices, indices_to_waveform).
    The sampler stage is DDPM whatever ``sampler_kind`` says, as the JAX
    stage is; it draws as ``refine_indices`` does, so under DDPM the
    stages compose to the serving path bit for bit. ``ref_compat`` defaults
    to False, as in JAX: ``cfg.dit.ref_compat`` is not read here. An
    ``F5PipelineConfig`` gives F5's stages (``f5_stage_fns``), and takes
    none of the DiTTo sampler's options."""
    if isinstance(cfg, F5PipelineConfig):
        _takes_no_ditto_options(sampler_kind, cond_by_audio, ref_compat)
        return f5_stage_fns(cfg, num_steps=num_steps)
    if isinstance(cfg, VallePipelineConfig):
        _takes_no_ditto_options(sampler_kind, cond_by_audio, ref_compat,
                                num_steps)
        return valle_stage_fns(cfg)
    kind = cfg.sampler.kind if sampler_kind is None else sampler_kind
    opts = dict(num_steps=num_steps, cond_by_audio=cond_by_audio,
                compat=ref_compat)
    sampler = _denoiser(cfg, kind="ddpm", **opts)
    denoise = _denoiser(cfg, kind=kind, **opts)

    def encode(params, audio, padding_mask):
        return encode_prompt_latents(params, cfg, audio, padding_mask)

    def vq_indices(params, refined):
        return refined_to_indices(params, refined, ref_exact=ref_compat)

    def codec_decode(params, indices, output_length):
        return _codec_decode(params, cfg, indices, output_length)

    def mel(params, wav):
        return _mel(cfg, wav[:, 0])

    def vocoder(params, m):
        return _vocode(params, cfg, m)

    def refine_indices(params, audio, padding_mask, text_ids, generator):
        latents = encode(params, audio, padding_mask)
        return vq_indices(params, denoise(params, latents, text_ids,
                                          generator))

    def indices_to_wav(params, indices, output_length):
        return indices_to_waveform(params, cfg, indices, output_length)

    return {"encode": encode, "sampler": sampler, "vq_indices": vq_indices,
            "codec_decode": codec_decode, "mel": mel, "vocoder": vocoder,
            "refine_indices": refine_indices,
            "indices_to_waveform": indices_to_wav}


def _on_dev(dev, a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a, dtype=dtype).to(dev)


def _inputs(dev, audio, padding_mask, text_ids):
    mask = None if padding_mask is None else torch.as_tensor(
        padding_mask).to(dev)
    return (_on_dev(dev, audio), mask,
            _on_dev(dev, text_ids, dtype=torch.int64))


def build_synthesize_pipelined(cfg: PipelineConfig, *,
                               num_steps: Optional[int] = None,
                               sampler_kind: Optional[str] = None,
                               cond_by_audio: bool = False,
                               ref_compat: Optional[bool] = None,
                               device=None):
    """Serving entry point: fn(params, audio, padding_mask, text_ids,
    generator) -> waveform [B, L'].

    audio [B, 1, L] float, padding_mask [B, L] (1 = valid) or None,
    text_ids [B, St] GPT2 ids, generator a ``torch.Generator`` on the
    device (None: the device's default generator). ``num_steps`` and
    ``sampler_kind`` ("ddpm" | "ddim") default to ``cfg.sampler``,
    ``ref_compat`` to ``cfg.dit.ref_compat``. An ``F5PipelineConfig``
    serves F5-TTS with the same call (see the module docstring), and takes
    none of the DiTTo sampler's options."""
    dev = resolve_device(device)
    if isinstance(cfg, F5PipelineConfig):
        _takes_no_ditto_options(sampler_kind, cond_by_audio, ref_compat)
        return _f5_synthesize(cfg, dev, num_steps)
    if isinstance(cfg, VallePipelineConfig):
        _takes_no_ditto_options(sampler_kind, cond_by_audio, ref_compat,
                                num_steps)
        return build_valle_synthesize(cfg, dev)
    stages = build_stage_fns(cfg, num_steps=num_steps,
                             sampler_kind=sampler_kind,
                             cond_by_audio=cond_by_audio,
                             ref_compat=cfg.dit.ref_compat
                             if ref_compat is None else ref_compat)

    @torch.inference_mode()
    def synthesize(params: GeneratorParams, audio, padding_mask, text_ids,
                   generator: Optional[torch.Generator] = None):
        with span("request", batch=audio.shape[0],
                  frames=_frames(cfg, audio.shape[-1])):
            audio, mask, text_ids = _inputs(dev, audio, padding_mask,
                                            text_ids)
            idx = stages["refine_indices"](params, audio, mask, text_ids,
                                           generator)
            return stages["indices_to_waveform"](params, idx,
                                                 audio.shape[-1])

    return synthesize


def build_synthesize(cfg: PipelineConfig, *, num_steps: Optional[int] = None,
                     sampler_kind: Optional[str] = None,
                     cond_by_audio: bool = False,
                     ref_compat: Optional[bool] = None, device=None):
    """The JAX one-jit entry point, kept for API parity. Eager PyTorch has
    no one-jit versus two-dispatch split, so it is
    ``build_synthesize_pipelined`` with the same arguments."""
    return build_synthesize_pipelined(
        cfg, num_steps=num_steps, sampler_kind=sampler_kind,
        cond_by_audio=cond_by_audio, ref_compat=ref_compat, device=device)


def build_synthesize_recorded(cfg: PipelineConfig, *,
                              num_steps: Optional[int] = None,
                              sampler_kind: Optional[str] = None,
                              cond_by_audio: bool = False,
                              ref_compat: Optional[bool] = None,
                              return_intermediates: bool = True,
                              device=None):
    """fn(params, audio, padding_mask, text_ids, prompt_noise, init_noise,
    step_noise) with explicit noise (prompt_noise [B, T, H]; init_noise
    [B, T, H] or None when cond_by_audio; step_noise [K, B, T, H], the
    sampler's draws, which DDIM scales by sigma). As in JAX, this form
    ignores ``cfg.sampler.clip_denoised``.

    Returns (waveform, intermediates) with latents, noised, refined,
    indices, codec_wav and mel, or the waveform alone."""
    dev = resolve_device(device)
    compat = cfg.dit.ref_compat if ref_compat is None else ref_compat
    kind = cfg.sampler.kind if sampler_kind is None else sampler_kind
    schedule, taus = _schedule(cfg, num_steps)

    @torch.inference_mode()
    def synthesize(params: GeneratorParams, audio, padding_mask, text_ids,
                   prompt_noise, init_noise, step_noise):
        with span("request", batch=audio.shape[0],
                  frames=_frames(cfg, audio.shape[-1])):
            audio, mask, text_ids = _inputs(dev, audio, padding_mask,
                                            text_ids)
            latents = encode_prompt_latents(params, cfg, audio, mask)
            text_emb = _text_emb(params, cfg, text_ids)
            t_full = torch.full((latents.shape[0],),
                                cfg.dit.diffusion_steps - 1,
                                dtype=torch.int64)
            noised = q_sample(schedule, latents, t_full,
                              _on_dev(dev, prompt_noise), ref_compat=compat)
            x_init = noised if cond_by_audio else _on_dev(dev, init_noise)
            refined = _sample(params, cfg, schedule, taus, x_init, text_emb,
                              kind=kind, noise_seq=_on_dev(dev, step_noise),
                              clip=False)
            indices = refined_to_indices(params, refined, ref_exact=compat)
            out, inter = indices_to_waveform(
                params, cfg, indices, audio.shape[-1],
                return_intermediates=True)
        if not return_intermediates:
            return out
        return out, {"latents": latents, "noised": noised, "refined": refined,
                     "indices": indices, **inter}

    return synthesize


# ---------------------------------------------------------------------------
# the SLP-driven chain (JAX generator.py:367-418)
# ---------------------------------------------------------------------------

def build_slp_stage_fns(cfg: PipelineConfig, *,
                        num_steps: Optional[int] = None,
                        byt5_cfg: Optional[ByT5Config] = None):
    """The stages of ``build_synthesize_with_slp``, each a plain function:

      slp(params, audio, padding_mask, byt5_ids, byt5_mask)
          -> (logits [B, nb_classes], frames [B])
      sampler(params, text_ids, frames, generator, init_noise=None,
              step_noise=None) -> refined [B, max_frames, H], zero past
          each utterance's frames (x_init fp32, always DDPM, as in JAX)
      tail(params, refined) -> waveform [B, max_frames * hop_length]

    max_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length).
    ``byt5_cfg`` None is byt5-small (JAX hard-codes it)."""
    schedule, taus = _schedule(cfg, num_steps)
    max_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length)
    bcfg = byt5_small_config() if byt5_cfg is None else byt5_cfg

    def slp(params, audio, padding_mask, byt5_ids, byt5_mask):
        with span("slp"):
            logits = slp_mod.slp_forward(
                params.slp, params.byt5, params.codec, cfg.slp, bcfg,
                cfg.codec, byt5_ids, byt5_mask, audio, padding_mask)
            return logits, slp_mod.slp_predict_frames(
                logits, frame_rate=cfg.audio.frame_rate,
                min_seconds=int(cfg.audio.min_audio_seconds))

    def sampler(params, text_ids, frames, generator=None, init_noise=None,
                step_noise=None):
        dev = text_ids.device
        x_init = init_noise
        if x_init is None:
            x_init = torch.randn(
                (text_ids.shape[0], max_frames, cfg.dit.hidden_dim),
                generator=generator, dtype=torch.float32, device=dev)
        refined = _sample(params, cfg, schedule, taus, x_init,
                          _text_emb(params, cfg, text_ids),
                          generator=generator, noise_seq=step_noise)
        valid = torch.arange(max_frames, device=dev)[None, :] < frames[:, None]
        return refined * valid[..., None]

    def tail(params, refined):
        # JAX line 415 passes no ref_compat: the VQ runs the default form
        return latents_to_waveform(params, cfg, refined,
                                   max_frames * cfg.codec.hop_length)

    return {"slp": slp, "sampler": sampler, "tail": tail}


def build_synthesize_with_slp(cfg: PipelineConfig, *,
                              num_steps: Optional[int] = None,
                              byt5_cfg: Optional[ByT5Config] = None,
                              device=None):
    """SLP-driven entry point: fn(params, audio, padding_mask, text_ids,
    byt5_ids, byt5_mask, generator, *, init_noise=None, step_noise=None)
    -> (waveform [B, max_frames * hop_length], frames [B]).

    ``params`` carries ``byt5`` and ``slp``. The generator draws x_init,
    then one draw per step; ``init_noise`` [B, max_frames, H] and
    ``step_noise`` [K, B, max_frames, H] replace those draws (parity
    runs)."""
    dev = resolve_device(device)
    st = build_slp_stage_fns(cfg, num_steps=num_steps, byt5_cfg=byt5_cfg)
    max_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length)

    @torch.inference_mode()
    def synthesize(params: GeneratorParams, audio, padding_mask, text_ids,
                   byt5_ids, byt5_mask,
                   generator: Optional[torch.Generator] = None, *,
                   init_noise=None, step_noise=None):
        with span("request", batch=audio.shape[0], frames=max_frames):
            audio, mask, text_ids = _inputs(dev, audio, padding_mask,
                                            text_ids)
            byt5_ids = _on_dev(dev, byt5_ids, dtype=torch.int64)
            byt5_mask = None if byt5_mask is None else torch.as_tensor(
                byt5_mask).to(dev)
            _, frames = st["slp"](params, audio, mask, byt5_ids, byt5_mask)
            refined = st["sampler"](params, text_ids, frames, generator,
                                    _on_dev(dev, init_noise),
                                    _on_dev(dev, step_noise))
            return st["tail"](params, refined), frames

    return synthesize


# ---------------------------------------------------------------------------
# the F5-TTS chain (F5-TTS infer/utils_infer.py:infer_batch_process)
# ---------------------------------------------------------------------------

def _takes_no_ditto_options(sampler_kind, cond_by_audio, ref_compat,
                            num_steps=None):
    """Raise where a DiTTo-only option is given with an F5 or VALL-E
    configuration: F5's sampler is its configuration's guided Euler flow,
    VALL-E's its decode (which has no ``num_steps`` either), whatever they
    would say."""
    given = [name for name, v in (("sampler_kind", sampler_kind is not None),
                                  ("cond_by_audio", cond_by_audio),
                                  ("ref_compat", bool(ref_compat)),
                                  ("num_steps", num_steps is not None)) if v]
    if given:
        raise ValueError(f"{', '.join(given)}: DiTTo sampler options, which "
                         "an F5 or VALL-E configuration does not take")


def _f5_gain(cfg: F5PipelineConfig, audio):
    """Each prompt's RMS [B] and the gain that lifts a quieter one to
    ``target_rms`` (1 for the others)."""
    rms = torch.sqrt(torch.mean(torch.square(audio.float()), dim=(1, 2)))
    target = cfg.sampler.target_rms
    return rms, torch.where(rms < target, target / rms,
                            torch.ones_like(rms))


def _f5_prepare(params, cfg: F5PipelineConfig, cond, text2):
    """(cond padded with zeros to the text's N frames, ``f5.prepare``)."""
    step_cond = F.pad(cond.float(), (0, 0, 0, text2.shape[1] - cond.shape[1]))
    return step_cond, f5_mod.prepare(params.dit, cfg.dit, step_cond, text2)


def _f5_sample(params, cfg: F5PipelineConfig, times, cond, text2,
               generator):
    """The full mel [B, N, mel] from the prompt's mel cond [B, P, mel] and
    the text embedding [2B, N, td]: y0 drawn from ``generator``, the
    guided Euler steps (graphed where ``step_graph.engages``), then the
    prompt's frames put back."""
    b, p, m = cond.shape
    n = text2.shape[1]
    y0 = torch.randn((b, n, m), generator=generator, dtype=torch.float32,
                     device=cond.device)
    with _sampling(y0, times.shape[0] - 1) as graph:
        step_cond, prep = _f5_prepare(params, cfg, cond, text2)

        def model_fn(y, t):
            return f5_mod.velocity(params.dit, cfg.dit, y, t, prep,
                                   cfg.sampler.cfg_strength)

        model_fn = graph(model_fn, lambda: times[:1].to(y0.device).expand(b),
                         (cfg.dit, cfg.sampler.cfg_strength,
                          tuple(text2.shape)))
        y = euler_sample(model_fn, y0, times)
        return torch.cat([step_cond[:, :p], y[:, p:]], dim=1)


def f5_stage_fns(cfg: F5PipelineConfig, *, num_steps: Optional[int] = None):
    """F5's chain as stages, each a plain function; they compose to
    ``build_synthesize_pipelined(cfg)`` bit for bit:

      mel(params, audio [B, 1, L]) -> (cond [B, P, mel], rms [B])
      text_encode(params, text_ids [B, Nt], frames) -> [2B, N, td]
      sampler(params, cond, text2, generator) -> mel [B, N, mel]
      vocoder(params, mel [B, mel, F]) -> waveform [B, F * hop]
      loudness(wave, rms) -> the waveform scaled back by the gain
      velocity(params, cond, text2, y, t) -> one guided velocity, eager
    """
    steps = cfg.sampler.steps if num_steps is None else num_steps
    times = sway_times(steps, cfg.sampler.sway_coef)
    v = cfg.vocoder

    def mel(params, audio):
        with span("mel"):
            rms, gain = _f5_gain(cfg, audio)
            m = get_mel_spectrogram(
                audio[:, 0].float() * gain[:, None],
                sample_rate=v.sampling_rate, n_fft=v.n_fft,
                num_mels=v.num_mels, hop=v.hop_size, win_size=v.win_size,
                fmin=v.fmin, fmax=v.fmax)
        return m.transpose(1, 2), rms

    def text_encode(params, text_ids, frames: int):
        with span("text_encode"):
            return f5_mod.text_embed(params.dit["text_embed"], cfg.dit,
                                     text_ids, frames)

    def sampler(params, cond, text2, generator):
        return _f5_sample(params, cfg, times, cond, text2, generator)

    def vocoder(params, m):
        return _vocode(params, cfg, m)

    def loudness(wave, rms):
        target = cfg.sampler.target_rms
        return torch.where((rms < target)[:, None], wave * (rms / target)[
            :, None], wave)

    def velocity(params, cond, text2, y, t):
        _, prep = _f5_prepare(params, cfg, cond, text2)
        return f5_mod.velocity(params.dit, cfg.dit, y, t, prep,
                               cfg.sampler.cfg_strength)

    return {"mel": mel, "text_encode": text_encode, "sampler": sampler,
            "vocoder": vocoder, "loudness": loudness, "velocity": velocity}


def _f5_synthesize(cfg: F5PipelineConfig, dev, num_steps: Optional[int]):
    st = f5_stage_fns(cfg, num_steps=num_steps)
    n = cfg.total_frames

    @torch.inference_mode()
    def synthesize(params, audio, padding_mask, text_ids,
                   generator: Optional[torch.Generator] = None):
        with span("request", batch=audio.shape[0], frames=n):
            audio, mask, text_ids = _inputs(dev, audio, padding_mask,
                                            text_ids)
            if mask is not None and not bool(mask.all()):
                raise ValueError("F5 serving takes prompts of one length: "
                                 "every sample of the padding mask valid")
            cond, rms = st["mel"](params, audio)
            if cond.shape[1] >= n:
                raise ValueError(f"a prompt of {cond.shape[1]} mel frames "
                                 f"leaves nothing of {n} to generate")
            text2 = st["text_encode"](params, text_ids, n)
            full = st["sampler"](params, cond, text2, generator)
            wave = st["vocoder"](params, full[:, cond.shape[1]:]
                                 .transpose(1, 2))
            return st["loudness"](wave, rms)

    return synthesize
