"""Log-mel spectrogram with BigVGAN's analysis semantics (the JAX
``ops/mel.py``): reflect pad by (n_fft - hop)/2, framed DFT as two fp32
matmuls with the periodic Hann window folded into the bases (center=False,
onesided), magnitude sqrt(re^2 + im^2 + 1e-9), slaney mel filterbank,
log(clamp(x, 1e-5))."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, num_mels: int,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[num_mels, 1 + n_fft//2] slaney-normalized triangular filters."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), num_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:num_mels + 2] - mel_f[:num_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int):
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def stft_magnitude(x, n_fft: int, hop: int, *, eps: float = 1e-9):
    """x: [B, T] already padded -> [B, n_freq, n_frames] |STFT|."""
    cos_b, sin_b = (torch.from_numpy(b).to(x.device) for b in _dft_bases(n_fft))
    frames = x.float().unfold(-1, n_fft, hop)           # [B, n, n_fft]
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return torch.sqrt(re * re + im * im + eps).transpose(1, 2)


def get_mel_spectrogram(wav, *, sample_rate: int = 24000, n_fft: int = 1024,
                        num_mels: int = 100, hop: int = 256,
                        win_size: int = 1024, fmin: float = 0.0,
                        fmax: Optional[float] = None):
    """wav: [B, T] in [-1, 1] -> log-mel [B, num_mels, frames]."""
    if win_size != n_fft:
        raise ValueError("the window is folded into the DFT bases: "
                         "win_size must equal n_fft")
    pad = (n_fft - hop) // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft_magnitude(x, n_fft, hop)
    basis = torch.from_numpy(
        mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)).to(x.device)
    mel = torch.matmul(basis, mag)
    return torch.log(torch.clamp(mel, min=1e-5))
