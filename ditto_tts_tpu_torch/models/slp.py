"""Speech Length Predictor (the JAX package's ``models/slp.py``).

ByT5 encodes the text; the codec and the SLP's embedding head encode the
audio into [B, nq, T, D] latents, flattened codebook-major to [B, nq*T, D]
(ref ``SpeechLP.py:48``); a causal transformer decoder cross-attends audio
to text; the last position predicts one of ``nb_classes`` duration classes
(seconds - 10).

``slp_predict_frames`` is the corrected decode of quirk #5 (the reference
uses the logits tensor as a shape, ``SpeechGenerator.py:156-158``): argmax
class + min_seconds, times the codec frame rate.
"""

from __future__ import annotations

from ..codec import encodec as codec_mod
from ..config import CodecConfig, SLPConfig
from ..nn.core import dense
from ..nn.transformer import transformer_decoder
from ..text import byt5 as byt5_mod


def slp_forward(trainable, byt5_params, codec_params, cfg: SLPConfig,
                byt5_cfg: byt5_mod.ByT5Config, codec_cfg: CodecConfig,
                text_ids, text_mask, audio, padding_mask=None):
    """Duration-class logits [B, nb_classes]."""
    z_text = byt5_mod.byt5_encode(byt5_params, byt5_cfg, text_ids, text_mask)
    codes = codec_mod.codec_encode(codec_params, codec_cfg, audio,
                                   padding_mask, bandwidth_kbps=1.5)
    z_audio = trainable["embedding_head"]["weight"][codes]  # [B, nq, T, D]
    b, nq, t, d = z_audio.shape
    z_audio = z_audio.reshape(b, nq * t, d)
    h = transformer_decoder(trainable["decoder"], cfg.num_heads, z_audio,
                            z_text, causal_self=True)
    return dense(trainable["length_predictor"], h[:, -1, :])


def slp_predict_frames(logits, frame_rate: int = 75, min_seconds: int = 10):
    """Class argmax (the first index wins a tie, as ``jnp.argmax``) ->
    seconds -> latent frames [B]."""
    return (logits.argmax(dim=-1) + min_seconds) * frame_rate
