"""SEANet encoder/decoder of the EnCodec-24kHz codec (the JAX
``codec/seanet.py``; behavioural spec HF EncodecEncoder/EncodecDecoder).

Encoder: init conv -> per ratio (strides 2,4,5,8) [resblock, ELU, strided
conv x2 channels] -> 2-layer residual LSTM -> ELU -> final conv.
Decoder mirrors it with transposed convs (strides 8,5,4,2).

Every stride-1 conv, from the 1-channel waveform ends to the 512-wide
bottleneck, goes through kernel B on the card (``ops.conv.conv1d``).
"""

from __future__ import annotations

import torch.nn.functional as F

from ..config import CodecConfig
from ..nn.conv import causal_conv1d, causal_conv_transpose1d
from ..nn.lstm import lstm


def _conv(p, cfg: CodecConfig, x, **kw):
    return causal_conv1d(x, p["weight"], p["bias"], causal=cfg.causal, **kw)


def _resblock(p, cfg: CodecConfig, x, dilation: int):
    y = _conv(p["conv1"], cfg, F.elu(x), dilation=dilation)
    y = _conv(p["conv2"], cfg, F.elu(y))
    return _conv(p["shortcut"], cfg, x) + y


def _residual_lstm(params, x):
    """x: [B, C, T]; the LSTM runs time-major, with a residual."""
    h = x.permute(2, 0, 1)             # [T, B, C]
    h = lstm(params, h) + h
    return h.permute(1, 2, 0)


def encode(params, cfg: CodecConfig, x):
    """x: [B, channels, L] waveform -> [B, dimension, frames] latents."""
    h = _conv(params["init_conv"], cfg, x)
    for stage, ratio in zip(params["stages"], reversed(cfg.ratios)):
        for j, rb in enumerate(stage["resblocks"]):
            h = _resblock(rb, cfg, h, cfg.dilation_base ** j)
        h = _conv(stage["down"], cfg, F.elu(h), stride=ratio)
    h = F.elu(_residual_lstm(params["lstm"], h))
    return _conv(params["final_conv"], cfg, h)


def decode(params, cfg: CodecConfig, z):
    """z: [B, dimension, frames] -> [B, channels, L] waveform."""
    h = _conv(params["init_conv"], cfg, z)
    h = _residual_lstm(params["lstm"], h)
    for stage, ratio in zip(params["stages"], cfg.ratios):
        h = causal_conv_transpose1d(
            F.elu(h), stage["up"]["weight"], stage["up"]["bias"],
            stride=ratio, causal=cfg.causal,
            trim_right_ratio=cfg.trim_right_ratio)
        for j, rb in enumerate(stage["resblocks"]):
            h = _resblock(rb, cfg, h, cfg.dilation_base ** j)
    return _conv(params["final_conv"], cfg, F.elu(h))
