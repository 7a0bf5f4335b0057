"""EnCodec-24kHz-compatible codec: encode -> RVQ codes -> decode (the JAX
``codec/encodec.py``; behavioural spec HF EncodecModel, single frame, no
normalization)."""

from __future__ import annotations

import math
from typing import Optional

from ..config import CodecConfig
from . import rvq, seanet


def _frame_rate(cfg: CodecConfig) -> int:
    return int(math.ceil(cfg.sample_rate / cfg.hop_length))


def codec_encode(params, cfg: CodecConfig, audio, padding_mask=None,
                 bandwidth_kbps: Optional[float] = 1.5):
    """audio: [B, channels, L]; padding_mask: [B, L] (1 = valid) -> codes
    [B, nq, T] (2 codebooks at 1.5 kbps)."""
    if padding_mask is not None:
        audio = audio * padding_mask[:, None, :].to(audio.dtype)
    latents = seanet.encode(params["encoder"], cfg, audio)
    nq = rvq.num_quantizers_for_bandwidth(
        cfg.codebook_size, _frame_rate(cfg), bandwidth_kbps,
        cfg.num_quantizers)
    return rvq.rvq_encode(params["quantizer"]["codebooks"], latents, nq)


def codec_decode(params, cfg: CodecConfig, codes,
                 output_length: Optional[int] = None):
    """codes: [B, nq, T] -> waveform [B, channels, L], cut to
    ``output_length`` when given."""
    latents = rvq.rvq_decode(params["quantizer"]["codebooks"], codes)
    audio = seanet.decode(params["decoder"], cfg, latents)
    if output_length is not None and audio.shape[-1] > output_length:
        audio = audio[..., :output_length]
    return audio
