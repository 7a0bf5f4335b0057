"""Kaiser-windowed sinc resampling (the JAX ``ops/resample.py``).

BigVGAN's alias-free resamplers (UpSample1d / DownSample1d with
``kaiser_sinc_filter1d``): the 2x zero-stuffed upsample and the 2x
anti-aliased decimation, with replicate edges. Filters are designed on the
host in numpy; the FIRs run as grouped ``F.conv_transpose1d`` / ``F.conv1d``
in fp32, as the JAX package leaves them to XLA. Only the composed
anti-aliased activation (``ops.snake.anti_aliased_activation``, the oracle
path) runs them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_beta(a: float) -> float:
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


@functools.lru_cache(maxsize=16)
def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """LPF impulse response [kernel_size]; DC gain normalized to 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4.0 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    window = np.kaiser(kernel_size, _kaiser_beta(a))
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _depthwise(filt: np.ndarray, x):
    """[C, 1, K] fp32 grouped-conv weight of taps rounded to x's type (the
    JAX package casts the filter to the signal's type)."""
    w = torch.from_numpy(filt).to(device=x.device, dtype=x.dtype).float()
    return w[None, None, :].expand(x.shape[1], 1, -1).contiguous()


def upsample1d(x, ratio: int = 2, kernel_size=None):
    """x [B, C, T] -> [B, C, T*ratio]: zero-stuffed, filtered, gain ratio."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    xp = F.pad(x.float(), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xp, _depthwise(filt, x), stride=ratio,
                                   groups=x.shape[1])
    return y[..., pad_left:y.shape[-1] - pad_right].to(x.dtype)


def lowpass1d(x, cutoff: float, half_width: float, *, stride: int = 1,
              kernel_size: int = 12):
    """Grouped low-pass FIR with replicate padding (LowPassFilter1d)."""
    filt = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
    even = kernel_size % 2 == 0
    xp = F.pad(x.float(), (kernel_size // 2 - int(even), kernel_size // 2),
               mode="replicate")
    return F.conv1d(xp, _depthwise(filt, x), stride=stride,
                    groups=x.shape[1]).to(x.dtype)


def downsample1d(x, ratio: int = 2, kernel_size=None):
    """x [B, C, T] -> [B, C, T//ratio]: anti-aliased decimation."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    return lowpass1d(x, 0.5 / ratio, 0.6 / ratio, stride=ratio,
                     kernel_size=k)
