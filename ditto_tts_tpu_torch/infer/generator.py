"""The DiTTo serving chain (the JAX ``infer/generator.py``).

  codec encode -> embedding head -> truncate to max_token_length frames ->
  channel mean -> [q_sample at t=T-1] -> K-step DDPM over the DiT,
  conditioned on GPT2 wte text embeddings -> repeat to 2 codebook channels
  -> VectorQuantizer indices -> codec decode -> mel -> BigVGAN -> waveform.

``build_synthesize_pipelined`` is the serving entry point: the two halves
of the JAX two-dispatch split (``refine_indices``, ``indices_to_waveform``)
run back to back on one stream with no host round-trip. Noise comes from a
``torch.Generator`` on the device. ``build_synthesize_recorded`` takes the
prompt, init and per-step noise explicitly and returns the intermediates,
for parity runs. ``build_stage_fns`` exposes the stages for timing.

Entry points run on ``cuda`` unless built with ``device="cpu"``; inputs are
moved to that device, and the parameters must already be there.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..codec import encodec as codec_mod
from ..codec import rvq as rvq_mod
from ..config import PipelineConfig
from ..diffusion.sampler import ddpm_sample, respaced_timesteps
from ..diffusion.schedule import NoiseSchedule, q_sample
from ..models import dit as dit_mod
from ..models import vocoder as voc_mod
from ..ops.mel import get_mel_spectrogram
from ..params import GeneratorParams
from ..text import gpt2 as gpt2_mod


def encode_prompt_latents(params: GeneratorParams, cfg: PipelineConfig,
                          audio, padding_mask=None):
    """Waveform -> channel-meaned latents [B, T <= max_token_length, H]."""
    codes = codec_mod.codec_encode(params.codec, cfg.codec, audio,
                                   padding_mask, bandwidth_kbps=1.5)
    latents = params.embedding_head["weight"][codes]      # [B, nq, T, H]
    return latents[:, :, :cfg.dit.max_token_length].mean(dim=1)


def _mel(cfg: PipelineConfig, wav):
    v = cfg.vocoder
    return get_mel_spectrogram(
        wav, sample_rate=v.sampling_rate, n_fft=v.n_fft, num_mels=v.num_mels,
        hop=v.hop_size, win_size=v.win_size, fmin=v.fmin, fmax=v.fmax)


def refined_to_indices(params: GeneratorParams, refined, *,
                       ref_exact: bool = False):
    """Refined latents [B, T, H] -> VQ indices [B, 2, T] (quirk #8: the
    latents are repeated to the 2 codebook channels)."""
    stacked = refined[:, None].expand(-1, 2, -1, -1)
    return rvq_mod.vq_indices(params.vector_quantizer, stacked,
                              ref_exact=ref_exact)


def indices_to_waveform(params: GeneratorParams, cfg: PipelineConfig,
                        indices, output_length: int, *,
                        return_intermediates: bool = False):
    """VQ indices -> codec decode -> mel -> BigVGAN waveform [B, L']."""
    wav = codec_mod.codec_decode(params.codec, cfg.codec, indices,
                                 output_length=output_length)
    mel = _mel(cfg, wav[:, 0])
    out = voc_mod.bigvgan_forward(params.vocoder, cfg.vocoder, mel)[:, 0]
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


def _sample(params, cfg: PipelineConfig, schedule, taus, x_init, text_emb,
            *, generator=None, noise_seq=None):
    prep = dit_mod.prepare(params.dit, cfg.dit, text_emb, x_init.shape[1])

    def model_fn(x, t):
        return dit_mod.ditto_forward(params.dit, cfg.dit, x, text_emb, t,
                                     prepared=prep)

    return ddpm_sample(model_fn, x_init, schedule, taus, noise_seq=noise_seq,
                       generator=generator,
                       clip_denoised=cfg.sampler.clip_denoised,
                       prediction_type=cfg.dit.prediction_type)


def _text_emb(params, cfg: PipelineConfig, text_ids):
    return gpt2_mod.embed_tokens(params.gpt2,
                                 text_ids[:, :cfg.dit.max_token_length])


def build_stage_fns(cfg: PipelineConfig):
    """The chain split into stages, each a plain function for timing:
    encode, sampler, vq_indices, codec_decode, mel, vocoder, and the two
    halves of the serving path (refine_indices, indices_to_waveform).
    The sampler starts from noise (the JAX default, cond_by_audio=False)."""
    if cfg.sampler.kind != "ddpm":
        raise NotImplementedError("the port's sampler is DDPM; ddim_sample "
                                  "is not ported yet")
    schedule = NoiseSchedule.cosine(cfg.dit.diffusion_steps)
    taus = respaced_timesteps(cfg.dit.diffusion_steps, cfg.sampler.num_steps)

    def encode(params, audio, padding_mask):
        return encode_prompt_latents(params, cfg, audio, padding_mask)

    def sampler(params, latents, text_ids, generator):
        text_emb = _text_emb(params, cfg, text_ids)
        x_init = torch.randn(latents.shape, generator=generator,
                             dtype=latents.dtype, device=latents.device)
        return _sample(params, cfg, schedule, taus, x_init, text_emb,
                       generator=generator)

    def vq_indices(params, refined):
        return refined_to_indices(params, refined,
                                  ref_exact=cfg.dit.ref_compat)

    def codec_decode(params, indices, output_length):
        return codec_mod.codec_decode(params.codec, cfg.codec, indices,
                                      output_length=output_length)

    def mel(params, wav):
        return _mel(cfg, wav[:, 0])

    def vocoder(params, m):
        return voc_mod.bigvgan_forward(params.vocoder, cfg.vocoder, m)[:, 0]

    def refine_indices(params, audio, padding_mask, text_ids, generator):
        latents = encode(params, audio, padding_mask)
        return vq_indices(params, sampler(params, latents, text_ids,
                                          generator))

    def indices_to_wav(params, indices, output_length):
        return indices_to_waveform(params, cfg, indices, output_length)

    return {"encode": encode, "sampler": sampler, "vq_indices": vq_indices,
            "codec_decode": codec_decode, "mel": mel, "vocoder": vocoder,
            "refine_indices": refine_indices,
            "indices_to_waveform": indices_to_wav}


def _inputs(dev, audio, padding_mask, text_ids):
    audio = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    mask = None if padding_mask is None else torch.as_tensor(
        padding_mask).to(dev)
    return audio, mask, torch.as_tensor(text_ids, dtype=torch.int64).to(dev)


def build_synthesize_pipelined(cfg: PipelineConfig, *, device=None):
    """Serving entry point: fn(params, audio, padding_mask, text_ids,
    generator) -> waveform [B, L'].

    audio [B, 1, L] float, padding_mask [B, L] (1 = valid) or None,
    text_ids [B, St] GPT2 ids, generator a ``torch.Generator`` on the
    device (None: the device's default generator)."""
    dev = resolve_device(device)
    stages = build_stage_fns(cfg)

    @torch.inference_mode()
    def synthesize(params: GeneratorParams, audio, padding_mask, text_ids,
                   generator: Optional[torch.Generator] = None):
        audio, mask, text_ids = _inputs(dev, audio, padding_mask, text_ids)
        idx = stages["refine_indices"](params, audio, mask, text_ids,
                                       generator)
        return stages["indices_to_waveform"](params, idx, audio.shape[-1])

    return synthesize


def build_synthesize_recorded(cfg: PipelineConfig, *,
                              cond_by_audio: bool = False,
                              ref_compat: Optional[bool] = None,
                              return_intermediates: bool = True,
                              device=None):
    """fn(params, audio, padding_mask, text_ids, prompt_noise, init_noise,
    step_noise) with explicit noise (prompt_noise [B, T, H]; init_noise
    [B, T, H] or None when cond_by_audio; step_noise [K, B, T, H]).

    Returns (waveform, intermediates) with latents, noised, refined,
    indices, codec_wav and mel, or the waveform alone."""
    dev = resolve_device(device)
    compat = cfg.dit.ref_compat if ref_compat is None else ref_compat
    schedule = NoiseSchedule.cosine(cfg.dit.diffusion_steps)
    taus = respaced_timesteps(cfg.dit.diffusion_steps, cfg.sampler.num_steps)

    @torch.inference_mode()
    def synthesize(params: GeneratorParams, audio, padding_mask, text_ids,
                   prompt_noise, init_noise, step_noise):
        audio, mask, text_ids = _inputs(dev, audio, padding_mask, text_ids)

        def on_dev(a):
            return None if a is None else torch.as_tensor(
                a, dtype=torch.float32).to(dev)

        latents = encode_prompt_latents(params, cfg, audio, mask)
        text_emb = _text_emb(params, cfg, text_ids)
        t_full = torch.full((latents.shape[0],), cfg.dit.diffusion_steps - 1,
                            dtype=torch.int64)
        noised = q_sample(schedule, latents, t_full, on_dev(prompt_noise),
                          ref_compat=compat)
        x_init = noised if cond_by_audio else on_dev(init_noise)
        refined = _sample(params, cfg, schedule, taus, x_init, text_emb,
                          noise_seq=on_dev(step_noise))
        indices = refined_to_indices(params, refined, ref_exact=compat)
        out, inter = indices_to_waveform(params, cfg, indices, audio.shape[-1],
                                         return_intermediates=True)
        if not return_intermediates:
            return out
        return out, {"latents": latents, "noised": noised, "refined": refined,
                     "indices": indices, **inter}

    return synthesize
