"""Neural Audio Codec: codec latents aligned to a GPT2 LM (the JAX
``models/nac.py``; ref ``src/model/NeuralAudioCodec.py:8-67``).

  frozen EnCodec encode -> codes [B, nq=2, T]
  trainable embedding head: codes -> latents [B, 2, T, hidden=768]
  trainable VectorQuantizer over the latents -> indices (used as codes)
  frozen EnCodec decode(indices) -> reconstruction; MSE against the input
  LM path: latents cut to GPT2's n_positions frames, mean over the codebook
  axis, into the frozen GPT2 as inputs_embeds, text ids as labels -> CE
  total = reconstruction + lambda * lm (+ the VQ losses)

The VQ is the straight-through estimator with codebook and commitment
losses by default; ``ref_compat=True`` is the reference's quirk #4
(argmin indices only, no VQ losses, no gradient to the codebook).

The codec runs under ``torch.no_grad()``: its encode feeds the trainable
head integer codes and its decode reads integer indices, so no gradient
crosses it, in JAX as here (on the card its convs are kernel B, which
refuses an input that requires grad). ``audio_encoder`` is shared with the
serving chain's prompt encode and the DiTTo step.

The trainable gathers (the embedding head, the VQ codebook) are
``F.embedding``: its backward sums a row's repeated codes in a fixed
order, where an indexing gather's backward adds them atomically on the
CPU, and two steps from one state would differ.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..codec import encodec as codec_mod
from ..codec import rvq as rvq_mod
from ..config import CodecConfig, GPT2Config, NACConfig
from ..params import fill_spec, nac_trainable_spec, tree_map
from ..text import gpt2 as gpt2_mod


def init_nac_trainable(cfg: NACConfig, seed: int = 0) -> Dict:
    """CPU fp32 ``{"embedding_head", "vector_quantizer"}``: an N(0, 1)
    head and a Xavier-uniform codebook from a numpy seed."""
    return tree_map(torch.from_numpy, fill_spec(nac_trainable_spec(cfg), seed))


def audio_encoder(trainable, codec_params, codec_cfg: CodecConfig, audio,
                  padding_mask=None):
    """Waveform [B, channels, L] -> (latents [B, nq, T, hidden], codes
    [B, nq, T]). ``trainable`` holds ``embedding_head``; the codec is
    frozen (no gradient reaches it: its convs are kernel B on the card)."""
    codes = codec_mod.codec_encode(codec_params, codec_cfg, audio,
                                   padding_mask, bandwidth_kbps=1.5)
    return F.embedding(codes, trainable["embedding_head"]["weight"]), codes


def nac_forward(trainable, codec_params, gpt2_params, nac_cfg: NACConfig,
                codec_cfg: CodecConfig, gpt2_cfg: GPT2Config, text_ids,
                text_mask, audio, padding_mask=None, *,
                ref_compat: bool = False) -> Dict:
    """The NAC's training forward: a dict of the losses (scalars) and the
    reconstructed audio and latents."""
    with torch.no_grad():
        codes = codec_mod.codec_encode(codec_params, codec_cfg, audio,
                                       padding_mask, bandwidth_kbps=1.5)
    latents = F.embedding(codes, trainable["embedding_head"]["weight"])

    if ref_compat:
        vq_indices = rvq_mod.vq_indices(trainable["vector_quantizer"],
                                        latents)
        vq_losses = {}
    else:
        _, vq_indices, vq_losses = rvq_mod.vq_straight_through(
            trainable["vector_quantizer"], latents)

    with torch.no_grad():
        recon = codec_mod.codec_decode(codec_params, codec_cfg, vq_indices,
                                       output_length=audio.shape[-1])
    reconstruction_loss = torch.mean(torch.square(
        recon.float() - audio.float()))

    # LM alignment: frames cut to GPT2's context, mean over the codebooks
    lm_latents = latents[:, :, :gpt2_cfg.n_positions].mean(dim=1)
    t = lm_latents.shape[1]
    logits = gpt2_mod.gpt2_logits(gpt2_params, gpt2_cfg, lm_latents,
                                  text_mask[:, :t])
    lm = gpt2_mod.lm_loss(logits, text_ids[:, :t])

    total = reconstruction_loss + nac_cfg.lambda_factor * lm
    for v in vq_losses.values():
        total = total + v
    return {"reconstructed_audio": recon, "audio_latents": latents,
            "lm_loss": lm, "reconstruction_loss": reconstruction_loss,
            "total_loss": total, **vq_losses}
