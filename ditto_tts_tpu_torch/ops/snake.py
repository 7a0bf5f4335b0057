"""Snake / SnakeBeta and their anti-aliased forms (the JAX ``ops/snake.py``
and ``ops/fir_gemm.py``).

  snake(x)     = x + (1/alpha) sin^2(alpha x)
  snakebeta(x) = x + (1/(beta+eps)) sin^2(alpha x)      (logscale: exp)

``polyphase_anti_aliased_activation`` is BigVGAN's Activation1d (2x
kaiser-sinc up, activation, 2x anti-aliased down) without the 2x-rate
signal: two 6-tap upsample phases, the activation on each, two 6-tap
decimation phases, with BigVGAN's replicate edges. It runs in fp32 and
returns x's type; the vocoder uses it for the activations outside the
fused act->conv widths and for act_post. ``snake_beta`` takes ``torch.sin``
unless asked for ``sin2`` (``fast``), as the JAX one takes ``jnp.sin``
unless ``fast``; the JAX vocoder sets ``fast`` for the standalone
activations of its default ``aa_impl="fused_conv"`` under
``layout="nlc"``. The fused kernels C and D, like the Pallas kernels they
replace, always take ``sin2``: sin^2 by a pi-periodic range reduction and
an odd polynomial (the JAX ``ops/fastmath.py``), branch-free and a
fraction of ``sinf``'s instructions on the card.

The vocoder's other ``aa_impl`` settings take the other two forms:
``anti_aliased_activation`` (composed: 2x-rate upsample, activation, 2x
decimation, the oracle) and ``polyphase_anti_aliased_activation_gemm`` (the
four 6-tap FIRs as banded matrix products, which the JAX package lowers to
XLA dot_generals; here ``torch.matmul``). Both run the activation on
tensors of x's type, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resample import downsample1d, kaiser_sinc_filter1d, upsample1d

_EPS = 1e-9

# sin2's constants, those of the JAX ops/fastmath.py (and csrc/aa_act.cuh)
_INV_PI = 0.3183098861837907
_PI_HI = 3.140625                  # n * _PI_HI is exact for |n| < 2^15
_PI_LO = 0.0009676535897932384
# sin(f) = f (c0 + c1 f^2 + c2 f^4 + c3 f^6 + c4 f^8) on [-pi/2, pi/2]
_SIN_C = (0.999999977, -0.166666476, 0.00833289979, -0.000198008956,
          2.59048416e-06)


def aa_filter() -> np.ndarray:
    """The 12-tap low-pass of BigVGAN's 2x up/down resampling (fp32)."""
    return kaiser_sinc_filter1d(0.25, 0.3, 12)


def sin2(x):
    """sin(x)^2 of an fp32 tensor via pi-periodic range reduction: x = n pi
    + f with |f| <= pi/2, then an odd degree-9 minimax polynomial in f
    (|sin err| < 3.4e-9 in f64; in fp32 within ~5e-7 of sin(x)^2 for |x|
    <~ 1e3). The arithmetic of the Pallas kernels and of kernels C and D."""
    n = torch.round(x * _INV_PI)
    f = x - n * _PI_HI - n * _PI_LO
    f2 = f * f
    c0, c1, c2, c3, c4 = _SIN_C
    s = f * (c0 + f2 * (c1 + f2 * (c2 + f2 * (c3 + f2 * c4))))
    return s * s


def snake_coeffs(alpha, beta=None, *, logscale: bool = True):
    """Per-channel fp32 (a, inv_b): a = exp(alpha) and inv_b =
    1/(exp(beta)+eps) under logscale; plain Snake uses beta = alpha."""
    a = alpha.float()
    b = a if beta is None else beta.float()
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return a, 1.0 / (b + _EPS)


def snake_beta(x, alpha, beta=None, *, logscale: bool = True,
               fast: bool = False):
    """x [B, C, T]; alpha, beta [C] (beta None: plain Snake). fp32 math,
    result in x's type. ``fast`` takes ``sin2`` for sin^2 (the JAX
    ``snake_beta(fast=True)``), else ``torch.sin``."""
    a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
    xf = x.float()
    if fast:
        s2 = sin2(a[:, None] * xf)
    else:
        s = torch.sin(a[:, None] * xf)
        s2 = s * s
    return (xf + inv_b[:, None] * s2).to(x.dtype)


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


def anti_aliased_activation(x, act_fn):
    """BigVGAN Activation1d: 2x upsample -> pointwise activation -> 2x
    downsample (x [B, C, T]; ``act_fn`` acts on tensors of x's type)."""
    return downsample1d(act_fn(upsample1d(x)))


_GEMM_TB = 128     # output samples per band block
_GEMM_HALO = 16    # extra samples a block reads (>= 6 taps - 1)


@functools.lru_cache(maxsize=16)
def _band_matrix(taps: tuple) -> np.ndarray:
    """[TB, TB + HALO] with A[i, i + m] = taps[m]."""
    a = np.zeros((_GEMM_TB, _GEMM_TB + _GEMM_HALO), np.float32)
    rows = np.arange(_GEMM_TB)
    for m, w in enumerate(taps):
        a[rows, rows + m] = w
    return a


def fir_gemm_t(x, taps, start: int, t_out: int):
    """out[b, c, t] = sum_m taps[m] x[b, c, t + start + m] for t < t_out, as
    one banded product over 128-sample blocks: operands in x's type (taps
    rounded to it), fp32 sums, result in x's type."""
    b, c, t_in = x.shape
    nb = -(-t_out // _GEMM_TB)
    need = start + (nb + 1) * _GEMM_TB
    if need > t_in:
        x = F.pad(x, (0, need - t_in))
    main = x[..., start:start + nb * _GEMM_TB].reshape(b, c, nb, _GEMM_TB)
    ext = x[..., start + _GEMM_TB:start + (nb + 1) * _GEMM_TB].reshape(
        b, c, nb, _GEMM_TB)
    win = torch.cat([main, ext[..., :_GEMM_HALO]], dim=3)
    a = torch.from_numpy(_band_matrix(tuple(float(t) for t in taps))).to(
        device=x.device, dtype=x.dtype).float()
    out = torch.matmul(win.float(), a.t()).to(x.dtype)
    return out.reshape(b, c, nb * _GEMM_TB)[..., :t_out]


def polyphase_anti_aliased_activation_gemm(x, act_fn):
    """``polyphase_anti_aliased_activation`` with each 6-tap FIR as a
    banded product (``fir_gemm_t``), carried in x's type as the JAX
    ``aa_impl="polyphase_gemm"`` is. x [B, C, T]; ``act_fn`` acts on
    tensors of x's type."""
    half = 6
    h = aa_filter()
    pad = half - 1
    t = x.shape[-1]
    xt = F.pad(x, (pad, pad), mode="replicate")
    se = act_fn(fir_gemm_t(xt, 2.0 * h[0::2], pad - 3, t))
    so = act_fn(fir_gemm_t(xt, 2.0 * h[1::2], pad - 2, t))
    lval, rval = se[..., :1], so[..., -1:]
    e_p = torch.cat([lval.expand(*lval.shape[:-1], half - 4), se,
                     rval.expand(*rval.shape[:-1], half - 3)], dim=-1)
    o_p = torch.cat([lval.expand(*lval.shape[:-1], half - 3), so,
                     rval.expand(*rval.shape[:-1], half - 4)], dim=-1)
    return fir_gemm_t(o_p, h[0::2], 0, t) + fir_gemm_t(e_p, h[1::2], 0, t)
