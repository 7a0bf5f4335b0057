"""The EnCodec 24 kHz codec (facebook/encodec_24khz geometry) in plain
fp32 PyTorch: the SEANet encoder and decoder with EnCodec's causal
reflect padding, the two-layer residual LSTM, and residual VQ; plus the
VQ lookups of the DiTTo chain and the log-mel analysis of BigVGAN
(``meldataset.get_mel_spectrogram``: reflect pad, periodic Hann, |STFT|
with 1e-9 under the root, slaney mel, log of clamp 1e-5).

Parameters are the weight tree the benchmark draws (the HF EncodecModel
layers by role: ``init_conv``, ``stages``, ``lstm``, ``final_conv``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import conv1d, conv_transpose1d, linear, matmul


def _reflect(x, left: int, right: int):
    n = x.shape[-1]
    extra = 0
    if n <= max(left, right):
        extra = max(left, right) - n + 1
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., :y.shape[-1] - extra] if extra else y


def sconv(p, x, prec, *, stride: int = 1, dilation: int = 1):
    """EnCodec's causal conv: the effective kernel less the stride padded
    on the left (reflect), and on the right what completes the last
    frame."""
    k = p["weight"].shape[-1]
    eff = (k - 1) * dilation + 1
    total = eff - stride
    n = x.shape[-1]
    frames = (n - eff + total) / stride + 1
    extra = max((math.ceil(frames) - 1) * stride + eff - total - n, 0)
    return conv1d(_reflect(x, total, extra), p["weight"], p["bias"],
                  prec=prec, stride=stride, dilation=dilation)


def _resblock(p, x, prec, dilation):
    y = sconv(p["conv1"], F.elu(x), prec, dilation=dilation)
    y = sconv(p["conv2"], F.elu(y), prec)
    return sconv(p["shortcut"], x, prec) + y


def lstm(layers, x, prec):
    """Stacked LSTM over x [T, B, C], gates (i, f, g, o), zero state."""
    for p in layers:
        gx = linear({"weight": p["weight_ih"],
                     "bias": p["bias_ih"] + p["bias_hh"]}, x, prec)
        hsz = p["weight_hh"].shape[1]
        h = x.new_zeros((x.shape[1], hsz))
        c = torch.zeros_like(h)
        outs = []
        for t in range(x.shape[0]):
            g = gx[t] + matmul(h, p["weight_hh"].t(), prec)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs)
    return x


def _residual_lstm(layers, x, prec):
    h = x.permute(2, 0, 1)
    return (lstm(layers, h, prec) + h).permute(1, 2, 0)


def encode(p, codec: dict, audio, prec):
    """Waveform [B, 1, L] -> latents [B, dimension, frames]."""
    h = sconv(p["init_conv"], audio, prec)
    for stage, r in zip(p["stages"], reversed(codec["ratios"])):
        for j, rb in enumerate(stage["resblocks"]):
            h = _resblock(rb, h, prec, codec["dilation_base"] ** j)
        h = sconv(stage["down"], F.elu(h), prec, stride=r)
    h = F.elu(_residual_lstm(p["lstm"], h, prec))
    return sconv(p["final_conv"], h, prec)


def decode(p, codec: dict, z, prec, length: int):
    """Latents [B, dimension, frames] -> waveform [B, 1, <= length]."""
    h = sconv(p["init_conv"], z, prec)
    h = _residual_lstm(p["lstm"], h, prec)
    for stage, r in zip(p["stages"], codec["ratios"]):
        y = conv_transpose1d(F.elu(h), stage["up"]["weight"],
                             stage["up"]["bias"], prec=prec, stride=r)
        h = y[..., :y.shape[-1] - r]        # causal: trim K - stride right
        for j, rb in enumerate(stage["resblocks"]):
            h = _resblock(rb, h, prec, codec["dilation_base"] ** j)
    return sconv(p["final_conv"], F.elu(h), prec)[..., :length]


def sq_distances(x, codebook, prec="float32", dtype=torch.float32):
    """Squared euclidean distances [N, K] of rows x [N, D] to codes."""
    x, cb = x.to(dtype), codebook.to(dtype)
    dots = matmul(x, cb.t(), prec).to(dtype) if dtype == torch.float32 \
        else x @ cb.t()
    return (x.square().sum(-1, keepdim=True) - 2.0 * dots
            + cb.square().sum(-1)[None])


def rvq_encode(codebooks, z, nq: int, prec):
    """Latents [B, D, T] -> codes [B, nq, T], greedy residual nearest."""
    res = z.transpose(1, 2)
    codes = []
    for q in range(nq):
        d = sq_distances(res.reshape(-1, res.shape[-1]), codebooks[q], prec)
        idx = d.argmin(-1).reshape(res.shape[:-1])
        res = res - codebooks[q][idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(codebooks, codes):
    out = sum(codebooks[q][codes[:, q]] for q in range(codes.shape[1]))
    return out.transpose(1, 2).float()


def codes_per_bandwidth(codec: dict, kbps: float) -> int:
    rate = math.ceil(codec["sample_rate"] / math.prod(codec["ratios"]))
    return max(1, int(math.floor(kbps * 1000
                                 / (math.log2(codec["codebook_size"]) * rate))))


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    logm = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, logm, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27 * (m - 15.0)),
                    m * (200.0 / 3))


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax):
    """Slaney-normalised triangular filters [n_mels, 1 + n_fft // 2]."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    lo = (freqs[None] - pts[:-2, None]) / (pts[1:-1] - pts[:-2])[:, None]
    hi = (pts[2:, None] - freqs[None]) / (pts[2:] - pts[1:-1])[:, None]
    w = np.maximum(0.0, np.minimum(lo, hi))
    return w * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def log_mel(voc: dict, wav, prec):
    """wav [B, L] -> log-mel [B, num_mels, frames]."""
    n, hop = voc["n_fft"], voc["hop_size"]
    pad = (n - hop) // 2
    x = F.pad(wav[:, None].float(), (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n, hop)                        # [B, F, n]
    t = np.arange(n)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * t / n)
    ang = 2 * np.pi * np.outer(t, np.arange(n // 2 + 1)) / n
    dev = wav.device
    cos = torch.tensor(win[:, None] * np.cos(ang), dtype=torch.float32,
                       device=dev)
    sin = torch.tensor(-win[:, None] * np.sin(ang), dtype=torch.float32,
                       device=dev)
    re, im = matmul(frames, cos, prec), matmul(frames, sin, prec)
    mag = torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)
    basis = torch.tensor(mel_basis(voc["sampling_rate"], n, voc["num_mels"],
                                   voc["fmin"], voc["fmax"]),
                         dtype=torch.float32, device=dev)
    return torch.log(torch.clamp(matmul(basis, mag, prec), min=1e-5))
