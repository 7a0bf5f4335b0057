"""BigVGAN v2 (nvidia/bigvgan_v2_24khz_100band_256x geometry) in plain
fp32 PyTorch, as BigVGAN's ``bigvgan.py`` and ``alias_free_activation``
build it: conv_pre, then per stage a transposed-conv upsample and the mean
of AMPBlock1 blocks (anti-aliased SnakeBeta -> dilated conv, twice, with
a residual), a last anti-aliased SnakeBeta, conv_post and a clamp to
[-1, 1].

The anti-aliased activation (``Activation1d``): a 2x upsample (12-tap
Kaiser-windowed sinc, replicate pad), SnakeBeta x + sin^2(e^a x) /
(e^b + 1e-9), a 2x low-pass decimation (replicate pad).

What the configuration's ``aa_impl="fused_conv"`` changes: in the stages
whose width lies in the fused band (``benchmark.work.act_conv``), each
activation that feeds a convolution takes its edges from the input
replicate-extended before the upsample, not from the 2x-rate signal's own
replicate pad; the convolution then zero-pads as ever. The two differ
within a few samples of each end.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import conv1d, conv_transpose1d

_EXT = 8        # replicate extension of a fused activation's input


def kaiser_sinc(cutoff: float, half_width: float, k: int):
    half = k // 2
    a = 2.285 * (half - 1) * math.pi * 4.0 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a >= 21 else 0.0)
    win = np.kaiser(k, beta)
    time = (np.arange(-half, half) + 0.5) if k % 2 == 0 \
        else np.arange(k) - half
    f = 2 * cutoff * win * np.sinc(2 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


def activation1d(x, a, b):
    """BigVGAN's Activation1d with SnakeBeta (logscale) on x [B, C, T]."""
    c = x.shape[1]
    filt = torch.from_numpy(kaiser_sinc(0.25, 0.3, 12)).to(x.device)
    w = filt[None, None].expand(c, 1, 12).contiguous()
    y = F.pad(x, (5, 5), mode="replicate")
    y = 2.0 * F.conv_transpose1d(y, w, stride=2, groups=c)[..., 15:-15]
    y = y + 1.0 / (torch.exp(b.float()) + 1e-9)[:, None] * torch.sin(
        torch.exp(a.float())[:, None] * y) ** 2
    y = F.pad(y, (5, 6), mode="replicate")
    return F.conv1d(y, w, stride=2, groups=c)


def activation_extended(x, a, b):
    """The fused pairs' activation: Activation1d of the input replicate-
    extended by a few samples, cut back to [0, T)."""
    y = activation1d(F.pad(x, (_EXT, _EXT), mode="replicate"), a, b)
    return y[..., _EXT:y.shape[-1] - _EXT]


def _conv_same(p, x, prec, dilation=1):
    k = p["weight"].shape[-1]
    return conv1d(x, p["weight"], p.get("bias"), prec=prec,
                  dilation=dilation, padding=(k * dilation - dilation) // 2)


def _amp(p, x, dils, prec, act):
    for i, d in enumerate(dils):
        xt = act(x, p["act1"][i]["alpha"], p["act1"][i]["beta"])
        xt = _conv_same(p["convs1"][i], xt, prec, d)
        xt = act(xt, p["act2"][i]["alpha"], p["act2"][i]["beta"])
        x = x + _conv_same(p["convs2"][i], xt, prec)
    return x


def forward(p, voc: dict, mel, prec, fused_widths=()):
    """mel [B, num_mels, F] -> waveform [B, F * 256] fp32; the stages of a
    width in ``fused_widths`` take the fused pairs' activation edges."""
    x = _conv_same(p["conv_pre"], mel.float(), prec)
    nk = len(voc["resblock_kernel_sizes"])
    for i, (r, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        up = p["ups"][i]
        x = conv_transpose1d(x, up["weight"], up.get("bias"), prec=prec,
                             stride=r, padding=(k - r) // 2)
        act = activation_extended if x.shape[1] in fused_widths \
            else activation1d
        x = sum(_amp(rb, x, voc["resblock_dilation_sizes"][j], prec, act)
                for j, rb in enumerate(p["resblocks"][i])) / nk
    x = activation1d(x, p["act_post"]["alpha"], p["act_post"]["beta"])
    x = conv1d(x, p["conv_post"]["weight"], None, prec=prec, padding=3)
    return torch.clamp(x, -1.0, 1.0)[:, 0]
