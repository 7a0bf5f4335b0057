"""BigVGAN v2 generator (24 kHz / 100-band / 256x), the JAX
``models/vocoder.py`` default path as it runs on the TPU.

  conv_pre (k=7) -> 6 stages of [polyphase upsample (4,4,2,2,2,2), mean of
  3 AMP residual blocks (k = 3,7,11; dilations 1,3,5)] -> anti-aliased
  SnakeBeta -> conv_post (k=7, no bias) -> clamp [-1, 1].

The signal is carried [B, C, T] throughout (the JAX NLC/NCL hybrid was a
TPU lane-padding device) in ``cfg.carry_dtype``; conv operands are cast to
``cfg.compute_dtype`` and sum in fp32. Inside the AMP blocks at widths
96..384 each act->conv pair is one fused kernel C call
(``ops.act_conv.aa_snake_conv1d``), as the JAX default ``aa_impl=
"fused_conv"`` dispatches; elsewhere (768, 48, 24 and act_post) the
polyphase activation runs in stock torch ops and the conv is kernel B.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import VocoderConfig
from ..nn.conv import conv_transpose1d_poly
from ..ops.act_conv import aa_snake_conv1d
from ..ops.conv import conv1d
from ..ops.snake import polyphase_anti_aliased_activation, snake_beta

FUSED_WIDTHS = (96, 384)   # the JAX fused_conv dispatch band, inclusive


def _get_padding(k: int, d: int) -> int:
    return (k * d - d) // 2


def _beta(act_params, cfg: VocoderConfig):
    return act_params["beta"] if cfg.activation == "snakebeta" else None


def _act(x, act_params, cfg: VocoderConfig):
    def fn(v):
        return snake_beta(v, act_params["alpha"], _beta(act_params, cfg),
                          logscale=cfg.snake_logscale)

    if not cfg.use_anti_aliasing:
        return fn(x)
    return polyphase_anti_aliased_activation(x, fn)


def _conv_same(p, x, *, dilation: int = 1, cdt=None):
    pad = _get_padding(p["weight"].shape[-1], dilation)
    return conv1d(F.pad(x, (pad, pad)), p["weight"], p.get("bias"),
                  dilation=dilation, compute_dtype=cdt)


def _amp_block(p, cfg: VocoderConfig, x, dilations, cdt):
    """AMPBlock1: [act, dilated conv, act, conv] x len(dilations), residual."""
    lo, hi = FUSED_WIDTHS
    fuse = cfg.use_anti_aliasing and lo <= x.shape[1] <= hi
    for i in range(len(p["convs1"])):
        if fuse:
            xt = x
            for act, conv, dil in ((p["act1"][i], p["convs1"][i], dilations[i]),
                                   (p["act2"][i], p["convs2"][i], 1)):
                xt = aa_snake_conv1d(
                    xt, act["alpha"], _beta(act, cfg), conv["weight"],
                    conv.get("bias"), dilation=dil,
                    logscale=cfg.snake_logscale, compute_dtype=cdt)
        else:
            xt = _act(x, p["act1"][i], cfg)
            xt = _conv_same(p["convs1"][i], xt, dilation=dilations[i],
                            cdt=cdt)
            xt = _act(xt, p["act2"][i], cfg)
            xt = _conv_same(p["convs2"][i], xt, cdt=cdt)
        x = x + xt
    return x


def bigvgan_forward(params, cfg: VocoderConfig, mel):
    """mel: [B, num_mels, T] -> waveform [B, 1, T * prod(rates)] (fp32)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = mel.to(getattr(torch, cfg.carry_dtype))
    x = _conv_same(params["conv_pre"], x, cdt=cdt)
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i, rate in enumerate(cfg.upsample_rates):
        k = cfg.upsample_kernel_sizes[i]
        up = params["ups"][i]
        y = conv_transpose1d_poly(x, up["weight"], up.get("bias"),
                                  stride=rate, compute_dtype=cdt)
        trim = (k - rate) // 2   # torch ConvTranspose1d padding
        if trim:
            y = y[..., trim:-trim]
        acc = None
        for j, rb in enumerate(params["resblocks"][i]):
            out = _amp_block(rb, cfg, y, cfg.resblock_dilation_sizes[j], cdt)
            acc = out if acc is None else acc + out
        x = acc / num_kernels
    x = _act(x, params["act_post"], cfg)
    x = _conv_same(params["conv_post"], x, cdt=cdt)
    return torch.clamp(x.float(), -1.0, 1.0)
