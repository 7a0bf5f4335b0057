"""The NAC's frozen audio encoder (the JAX ``models/nac.py:audio_encoder``):
EnCodec codes at 1.5 kbps, then the embedding head's gather. The serving
chain's prompt encode and the DiTTo training step's audio path share it;
the rest of the NAC (its forward and losses) is not ported yet.
"""

from __future__ import annotations

from ..codec import encodec as codec_mod
from ..config import CodecConfig


def audio_encoder(trainable, codec_params, codec_cfg: CodecConfig, audio,
                  padding_mask=None):
    """Waveform [B, channels, L] -> (latents [B, nq, T, hidden], codes
    [B, nq, T]). ``trainable`` holds ``embedding_head``; the codec is
    frozen (no gradient reaches it: its convs are kernel B on the card)."""
    codes = codec_mod.codec_encode(codec_params, codec_cfg, audio,
                                   padding_mask, bandwidth_kbps=1.5)
    return trainable["embedding_head"]["weight"][codes], codes
