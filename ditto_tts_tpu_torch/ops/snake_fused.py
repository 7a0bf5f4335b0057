"""Standalone fused anti-aliased Snake / SnakeBeta: the plain versions and
kernel D's wrapper.

  fused_snake(x [B, C, T], alpha, beta)      the JAX Pallas
      ``ops/snake_pallas.py:fused_snake_pallas``
  fused_snake_nlc(x [B, T, C], alpha, beta)  the JAX Pallas
      ``ops/snake_pallas_nlc.py:fused_snake_nlc``

Both compute 2x kaiser-sinc upsample -> snake(beta) -> 2x decimation with
the Pallas kernels' edge semantics: x is replicate-padded by 8 samples
(not the 2x-rate signal, as the polyphase oracle pads), so within 3
samples of the ends they differ slightly from it. They differ from each
other in the upsample taps: ``fused_snake_nlc`` casts x to fp32 first;
``fused_snake_pallas`` multiplies in x's type, so in bf16 the taps, the
products and each running sum but the last are rounded to bf16 (the last
sum feeds the fp32 snake and XLA keeps it in fp32). The snake and the
decimation run in fp32; the result has x's type. The snake's sin^2 is the
Pallas kernels' pi-periodic polynomial (``ops.snake.sin2``), as kernel D
computes it.

A CPU tensor takes ``fused_snake_plain``; a CUDA tensor launches kernel D
(``csrc/snake.cu``) or raises (also, having no backward, on an input that
requires grad under grad mode: ``kernels.forbid_grad``). Both layouts go
through one kernel on a [B, C, T] view with the tensor's own strides.

  polyphase_snake(x [B, C, T], alpha, beta, fast=...)   the JAX
      ``polyphase_anti_aliased_activation(x, snake_beta(fast=...))``

is the same activation with the polyphase form's edges (the 2x-rate
signal replicate-padded) and its arithmetic: fp32 inside, sin^2 by
``sin2`` under ``fast``, else by ``torch.sin``. A CPU tensor takes
``polyphase_snake_plain`` (``ops.snake.polyphase_anti_aliased_activation``
itself); a CUDA tensor launches kernel D in its polyphase mode, which sums
in the plain form's order (so differs from it only where the card fuses a
multiply and an add), or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .snake import (aa_filter, polyphase_anti_aliased_activation, sin2,
                    snake_coeffs, snake_of)

_P = 8   # replicate-pad samples per side (the Pallas kernels' halo)


# ditto_snake's modes (csrc/snake.cu)
_PALLAS_F32_TAPS, _PALLAS_X_TAPS, _POLY, _POLY_SINF = range(4)


@functools.lru_cache(maxsize=1)
def phase_taps() -> np.ndarray:
    """[24] fp32 in the Pallas kernels' order: upsample 2h[2m+1] (-> e),
    2h[2m] (-> o); decimation h[2m+1] (on s(e)), h[2m] (on s(o))."""
    h = aa_filter()
    return np.concatenate([2.0 * h[1::2], 2.0 * h[0::2], h[1::2],
                           h[0::2]]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def polyphase_taps() -> np.ndarray:
    """[24] fp32 in ``polyphase_anti_aliased_activation``'s order: upsample
    2h[2r] (-> e), 2h[2r+1] (-> o); decimation h[2r+1] (on s(e)), h[2r]
    (on s(o))."""
    h = aa_filter()
    return np.concatenate([2.0 * h[0::2], 2.0 * h[1::2], h[1::2],
                           h[0::2]]).astype(np.float32)


def fused_snake_plain(x, a, inv_b, *, up_in_x_dtype: bool):
    """x [B, C, T] (any strides), fp32 or bf16; a, inv_b [C] fp32 (see
    ``snake_coeffs``). ``up_in_x_dtype``: the upsample taps of
    ``fused_snake_pallas`` (True) or ``fused_snake_nlc`` (False). Returns
    [B, C, T] in x's type."""
    t = x.shape[-1]
    tp = phase_taps()
    he, ho, ge, go = tp[0:6], tp[6:12], tp[12:18], tp[18:24]
    n = t + 8                                   # phase rows u in [-4, T+4)
    xp = F.pad(x.float(), (_P, _P), mode="replicate")
    if up_in_x_dtype and x.dtype != torch.float32:
        def r(v):
            return v.to(x.dtype).float()
        he, ho = (torch.from_numpy(w).to(x.dtype).float().tolist()
                  for w in (he, ho))
    else:
        def r(v):
            return v

    def phase(w, base):
        # sum_m w[m] x[u + base - 8 - m], in the Pallas kernel's order
        acc = r(float(w[0]) * xp[..., base:base + n])
        for m in range(1, 6):
            s = acc + r(float(w[m]) * xp[..., base - m:base - m + n])
            acc = s if m == 5 else r(s)
        return acc

    av, ib = a[:, None], inv_b[:, None]

    def snake(v):
        return v + ib * sin2(av * v)

    se = snake(phase(he, _P - 2))
    so = snake(phase(ho, _P - 1))
    acc = float(ge[0]) * se[..., 2:2 + t] + float(go[0]) * so[..., 1:1 + t]
    for m in range(1, 6):
        acc = acc + float(ge[m]) * se[..., m + 2:m + 2 + t] \
            + float(go[m]) * so[..., m + 1:m + 1 + t]
    return acc.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_float)] \
    + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)] * 2 \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _snake_cuda(x, a, inv_b, mode: int, taps: np.ndarray):
    kernels.forbid_grad("snake", x, a, inv_b)
    kernels.require_cuda("snake", x, a, inv_b)
    if x.dtype not in kernels.DTYPE_CODES or x.dim() != 3:
        raise TypeError(f"snake: fp32 or bf16 [B, C, T] x, got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, c, t = x.shape
    if t < 1:
        raise ValueError("snake: empty time axis")
    for name, v in (("a", a), ("inv_b", inv_b)):
        if v.dtype != torch.float32 or v.shape != (c,) or \
                not v.is_contiguous():
            raise ValueError(f"snake: {name} must be contiguous fp32 of "
                             f"shape ({c},)")
    y = torch.empty_like(x)
    xs = (ctypes.c_longlong * 3)(*x.stride())
    ys = (ctypes.c_longlong * 3)(*y.stride())
    time_minor = abs(x.stride(2)) <= abs(x.stride(1))
    fn = kernels.function("snake", "ditto_snake", _ARGTYPES)
    err = fn(x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), y.data_ptr(),
             taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, c, t,
             xs, ys, mode, int(time_minor), kernels.DTYPE_CODES[x.dtype],
             kernels.stream_ptr(x))
    kernels.check(err, "snake")
    kernels.launches["snake"] += 1
    return y


def fused_snake_cuda(x, a, inv_b, *, up_in_x_dtype: bool):
    """Kernel D; the operands of ``fused_snake_plain`` on one CUDA device.
    x may have any strides; y has x's strides when x is dense (a [B, T, C]
    tensor seen as [B, C, T] stays channels-minor)."""
    return _snake_cuda(x, a, inv_b,
                       _PALLAS_X_TAPS if up_in_x_dtype else _PALLAS_F32_TAPS,
                       phase_taps())


def polyphase_snake_plain(x, a, inv_b, *, fast: bool):
    """x [B, C, T], fp32 or bf16; a, inv_b [C] fp32 (see ``snake_coeffs``).
    ``polyphase_anti_aliased_activation`` with ``snake_beta``'s arithmetic
    (``ops.snake.snake_of``); [B, C, T] in x's type."""
    return polyphase_anti_aliased_activation(
        x, lambda v: snake_of(v, a, inv_b, fast=fast))


def polyphase_snake_cuda(x, a, inv_b, *, fast: bool):
    """Kernel D in its polyphase mode; the operands of
    ``polyphase_snake_plain`` on one CUDA device, x of any strides (sin^2
    by ``sin2f`` under ``fast``, else by ``sinf``)."""
    return _snake_cuda(x, a, inv_b, _POLY if fast else _POLY_SINF,
                       polyphase_taps())


def polyphase_snake(x, alpha, beta=None, *, logscale: bool = True,
                    fast: bool = False):
    """x [B, C, T]; alpha / beta [C] (beta None: plain Snake).
    ``polyphase_anti_aliased_activation(x, snake_beta(..., fast=fast))``,
    [B, C, T] in x's type: on the CPU the plain version, on a CUDA tensor
    one launch of kernel D."""
    a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
    if x.device.type == "cpu":
        return polyphase_snake_plain(x, a, inv_b, fast=fast)
    return polyphase_snake_cuda(x, a.contiguous(), inv_b.contiguous(),
                                fast=fast)


def _fused(xv, alpha, beta, logscale, up_in_x_dtype):
    a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
    if xv.device.type == "cpu":
        return fused_snake_plain(xv, a, inv_b, up_in_x_dtype=up_in_x_dtype)
    return fused_snake_cuda(xv, a.contiguous(), inv_b.contiguous(),
                            up_in_x_dtype=up_in_x_dtype)


def fused_snake(x, alpha, beta=None, *, logscale: bool = True):
    """x [B, C, T]; alpha / beta [C] (beta None: plain Snake). The
    anti-aliased Snake(Beta) of ``fused_snake_pallas``, [B, C, T] in x's
    type."""
    return _fused(x, alpha, beta, logscale, True)


def fused_snake_nlc(x, alpha, beta=None, *, logscale: bool = True):
    """x [B, T, C]; alpha / beta [C]. The anti-aliased Snake(Beta) of
    ``fused_snake_nlc`` (fp32 interior), [B, T, C] in x's type."""
    return _fused(x.transpose(1, 2), alpha, beta, logscale,
                  False).transpose(1, 2)
