"""EnCodec-24kHz-compatible codec: encode -> RVQ codes -> decode (the JAX
``codec/encodec.py``; behavioural spec HF EncodecModel, single frame, no
normalization), and ``import_hf_state_dict``, which folds torch weight
norm (``weight_g`` / ``weight_v`` or ``parametrizations``) into plain
conv weights."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# HF checkpoint import
# ---------------------------------------------------------------------------

def _fold_weight_norm(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """A conv weight under torch's weight-norm names folded into a plain
    weight, ``g * v / ||v||`` over dims (1, 2), in numpy as JAX folds it."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g = np.asarray(sd[f"{prefix}.weight_g"])
        v = np.asarray(sd[f"{prefix}.weight_v"])
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = np.asarray(sd[f"{prefix}.parametrizations.weight.original0"])
        v = np.asarray(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        raise KeyError(f"no weight found under {prefix}")
    norm = np.sqrt(np.sum(v ** 2, axis=(1, 2), keepdims=True))
    return g * v / norm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv_from(sd, prefix) -> Dict:
    return {"weight": _t(_fold_weight_norm(sd, f"{prefix}.conv")),
            "bias": _t(sd[f"{prefix}.conv.bias"])}


def _lstm_from(sd, prefix, num_layers) -> list:
    return [{name: _t(sd[f"{prefix}.lstm.{name}_l{i}"])
             for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            for i in range(num_layers)]


def _resblock_from(sd, prefix) -> Dict:
    # HF resblock module list: [ELU, conv, ELU, conv]; shortcut conv
    return {"conv1": _conv_from(sd, f"{prefix}.block.1"),
            "conv2": _conv_from(sd, f"{prefix}.block.3"),
            "shortcut": _conv_from(sd, f"{prefix}.shortcut")}


def import_hf_state_dict(sd: Dict[str, np.ndarray],
                         cfg: CodecConfig) -> Dict:
    """An HF EncodecModel state dict (numpy arrays or CPU tensors) as the
    codec's param tree of CPU tensors. Walks the encoder and decoder layer
    lists in construction order (conv, [res x N, ELU, down] per ratio,
    LSTM, ELU, final conv, and the decoder's mirror), skipping the
    parameter-less ELU slots."""
    nres = cfg.num_residual_layers

    enc: Dict = {"init_conv": _conv_from(sd, "encoder.layers.0")}
    idx = 1
    stages = []
    for _ in cfg.ratios:
        res = []
        for _ in range(nres):
            res.append(_resblock_from(sd, f"encoder.layers.{idx}"))
            idx += 1
        idx += 1  # ELU
        stages.append({"resblocks": res,
                       "down": _conv_from(sd, f"encoder.layers.{idx}")})
        idx += 1
    enc["stages"] = stages
    enc["lstm"] = _lstm_from(sd, f"encoder.layers.{idx}", cfg.lstm_layers)
    idx += 2  # lstm, ELU
    enc["final_conv"] = _conv_from(sd, f"encoder.layers.{idx}")

    dec: Dict = {"init_conv": _conv_from(sd, "decoder.layers.0"),
                 "lstm": _lstm_from(sd, "decoder.layers.1", cfg.lstm_layers)}
    idx = 2
    stages = []
    for _ in cfg.ratios:
        idx += 1  # ELU
        up = _conv_from(sd, f"decoder.layers.{idx}")
        idx += 1
        res = []
        for _ in range(nres):
            res.append(_resblock_from(sd, f"decoder.layers.{idx}"))
            idx += 1
        stages.append({"up": up, "resblocks": res})
    dec["stages"] = stages
    idx += 1  # ELU
    dec["final_conv"] = _conv_from(sd, f"decoder.layers.{idx}")

    codebooks = np.stack([
        np.asarray(sd[f"quantizer.layers.{q}.codebook.embed"])
        for q in range(cfg.num_quantizers)])
    return {"encoder": enc, "decoder": dec,
            "quantizer": {"codebooks": _t(codebooks)}}
