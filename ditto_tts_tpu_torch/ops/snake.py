"""Snake / SnakeBeta and their anti-aliased polyphase form (the JAX
``ops/snake.py`` and the kaiser filter of ``ops/resample.py``).

  snake(x)     = x + (1/alpha) sin^2(alpha x)
  snakebeta(x) = x + (1/(beta+eps)) sin^2(alpha x)      (logscale: exp)

``polyphase_anti_aliased_activation`` is BigVGAN's Activation1d (2x
kaiser-sinc up, activation, 2x anti-aliased down) without the 2x-rate
signal: two 6-tap upsample phases, the activation on each, two 6-tap
decimation phases, with BigVGAN's replicate edges. It runs in fp32 and
returns x's type; the vocoder uses it for the activations outside the
fused act->conv widths and for act_post. The TPU's fast polynomial sin^2
was a Mosaic workaround; the port uses ``torch.sin``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_EPS = 1e-9


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


def aa_filter() -> np.ndarray:
    """The 12-tap low-pass of BigVGAN's 2x up/down resampling (fp32)."""
    return kaiser_sinc_filter1d(0.25, 0.3, 12)


def snake_coeffs(alpha, beta=None, *, logscale: bool = True):
    """Per-channel fp32 (a, inv_b): a = exp(alpha) and inv_b =
    1/(exp(beta)+eps) under logscale; plain Snake uses beta = alpha."""
    a = alpha.float()
    b = a if beta is None else beta.float()
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return a, 1.0 / (b + _EPS)


def snake_beta(x, alpha, beta=None, *, logscale: bool = True):
    """x [B, C, T]; alpha, beta [C] (beta None: plain Snake). fp32 math,
    result in x's type."""
    a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
    xf = x.float()
    s = torch.sin(a[:, None] * xf)
    return (xf + inv_b[:, None] * (s * s)).to(x.dtype)


def polyphase_anti_aliased_activation(x, act_fn):
    """Anti-aliased activation of x [B, C, T] (time last); ``act_fn`` acts
    on fp32 [B, C, T] tensors. Exact to fp32 round-off against the composed
    up -> act -> down form, including its replicate-pad edges."""
    half = 6
    h = aa_filter()
    pad = half - 1
    t = x.shape[-1]
    xt = torch.nn.functional.pad(x.float(), (pad, pad), mode="replicate")

    def taps(weights, base, src):
        acc = float(weights[0]) * src[..., base:base + t]
        for r in range(1, half):
            acc = acc + float(weights[r]) * src[..., base + r:base + r + t]
        return acc

    # upsample phases (the x2 transposed-conv gain folded in)
    se = act_fn(taps(2.0 * h[0::2], pad - 3, xt))
    so = act_fn(taps(2.0 * h[1::2], pad - 2, xt))
    # decimation with the 2x-rate replicate edges (left e[0], right o[-1])
    lval, rval = se[..., :1], so[..., -1:]
    e_p = torch.cat([lval.expand(*lval.shape[:-1], half - 4), se,
                     rval.expand(*rval.shape[:-1], half - 3)], dim=-1)
    o_p = torch.cat([lval.expand(*lval.shape[:-1], half - 3), so,
                     rval.expand(*rval.shape[:-1], half - 4)], dim=-1)
    return (taps(h[0::2], 0, o_p) + taps(h[1::2], 0, e_p)).to(x.dtype)
