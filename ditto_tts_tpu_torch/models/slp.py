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

import torch
import torch.nn.functional as F

from ..codec import encodec as codec_mod
from ..config import CodecConfig, SLPConfig
from ..nn.core import dense
from ..nn.transformer import transformer_decoder
from ..params import fill_spec, slp_spec, tree_map
from ..text import byt5 as byt5_mod


def init_slp_trainable(cfg: SLPConfig, codebook_size: int = 1024,
                       seed: int = 0):
    """CPU fp32 ``{"embedding_head", "decoder", "length_predictor"}`` with
    the JAX init trees' structure, shapes and distributions, from a numpy
    seed (``params.slp_spec``)."""
    return tree_map(torch.from_numpy,
                    fill_spec(slp_spec(cfg, codebook_size), seed))


def slp_forward(trainable, byt5_params, codec_params, cfg: SLPConfig,
                byt5_cfg: byt5_mod.ByT5Config, codec_cfg: CodecConfig,
                text_ids, text_mask, audio, padding_mask=None, *,
                mesh=None):
    """Duration-class logits [B, nb_classes]. ``mesh``: the decoder under
    tensor parallelism (``nn/transformer.py``), None for none."""
    z_text = byt5_mod.byt5_encode(byt5_params, byt5_cfg, text_ids, text_mask)
    codes = codec_mod.codec_encode(codec_params, codec_cfg, audio,
                                   padding_mask, bandwidth_kbps=1.5)
    # F.embedding: a deterministic backward (models/nac.py)
    z_audio = F.embedding(codes, trainable["embedding_head"]["weight"])
    b, nq, t, d = z_audio.shape
    z_audio = z_audio.reshape(b, nq * t, d)
    h = transformer_decoder(trainable["decoder"], cfg.num_heads, z_audio,
                            z_text, causal_self=True, mesh=mesh)
    return dense(trainable["length_predictor"], h[:, -1, :])


def slp_predict_frames(logits, frame_rate: int = 75, min_seconds: int = 10):
    """Class argmax (the first index wins a tie, as ``jnp.argmax``) ->
    seconds -> latent frames [B]."""
    return (logits.argmax(dim=-1) + min_seconds) * frame_rate
