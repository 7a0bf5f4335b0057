"""Fused anti-aliased SnakeBeta -> 'SAME' dilated conv1d on [B, C, T]:
the plain version and kernel C's wrapper.

``aa_snake_conv1d`` computes what the Pallas kernel
``ditto_tts_tpu/ops/act_conv_pallas.py:aa_snake_conv1d`` computes, with its
edge semantics: x (cast to the compute type) is replicate-padded, the
activation runs in fp32 (two 6-tap upsample phases, snake with the Pallas
kernel's polynomial sin^2 ``ops.snake.sin2``, 12-tap decimation), rows
outside [0, T) are zeroed, the activation is rounded to
the compute type, and the dilated taps sum in fp32 with the bias before
the single cast to x's type. ``aa_snake_conv1d_ncl`` is the counterpart of
the time-minor twin ``aa_snake_conv1d_ncl``: the same function plus an
optional residual, added in fp32 before that cast. A CPU tensor takes
``aa_snake_conv1d_plain``; a CUDA tensor launches kernel C
(``csrc/act_conv.cu``) or raises; with no backward, it raises too on an
input that requires grad under grad mode (``kernels.forbid_grad``).

Like the Pallas wrappers, a sequence shorter than the kernel's two-block
halo runs the unfused form (polyphase activation, zero pad, conv, then the
residual in the output type) instead; the halo rounds to 16 samples for
``aa_snake_conv1d`` and to 128 for ``aa_snake_conv1d_ncl``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .conv import conv1d, conv1d_plain
from .snake import aa_filter, polyphase_anti_aliased_activation, sin2, \
    snake_beta, snake_coeffs

_AH = 8   # the Pallas kernel's activation halo rows per side


@functools.lru_cache(maxsize=1)
def fused_taps() -> np.ndarray:
    """[24] fp32: upsample phases 2h[2r], 2h[2r+1], decimation phases
    h[2r+1] (on the even branch), h[2r] (on the odd branch)."""
    h = aa_filter()
    return np.concatenate([2.0 * h[0::2], 2.0 * h[1::2], h[1::2],
                           h[0::2]]).astype(np.float32)


def aa_snake_conv1d_plain(x, a, inv_b, weight, bias=None, *,
                          dilation: int = 1, residual=None, out_dtype=None):
    """x [B, C, T] in the compute type; a, inv_b [C] fp32 (see
    ``snake_coeffs``); weight [O, C, K] in the compute type; bias [O] fp32
    or None; residual [B, O, T] or None. Returns [B, O, T] in ``out_dtype``
    (default x's type)."""
    k = weight.shape[-1]
    ca = (k - 1) * dilation // 2
    t = x.shape[-1]
    tp = fused_taps()
    eu, ou, ze, zo = tp[0:6], tp[6:12], tp[12:18], tp[18:24]
    nz = t + 2 * ca                       # act rows [-ca, T+ca)
    nph = nz + 6                          # phase rows [-ca-3, T+ca+3)
    xp = F.pad(x.float(), (ca + 6, ca + 6), mode="replicate")

    def fir(w, start, src, n):
        acc = float(w[0]) * src[..., start:start + n]
        for m in range(1, 6):
            acc = acc + float(w[m]) * src[..., start + m:start + m + n]
        return acc

    av, ib = a[:, None], inv_b[:, None]

    def act(v):
        return v + ib * sin2(av * v)

    se = act(fir(eu, 0, xp, nph))
    so = act(fir(ou, 1, xp, nph))
    z = float(zo[0]) * so[..., 0:nz] + float(ze[0]) * se[..., 1:1 + nz]
    for m in range(1, 6):
        z = z + float(zo[m]) * so[..., m:m + nz] \
            + float(ze[m]) * se[..., m + 1:m + 1 + nz]
    z[..., :ca] = 0.0
    z[..., ca + t:] = 0.0
    # rounded to the compute type, then the fp32 sums
    acc = conv1d_plain(z.to(x.dtype).float(), weight.float(), bias,
                       dilation=dilation)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype or x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_float)] \
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def aa_snake_conv1d_cuda(x, a, inv_b, weight, bias=None, *,
                         dilation: int = 1, residual=None, out_dtype=None):
    """Kernel C; the operands of ``aa_snake_conv1d_plain``, contiguous, on
    one CUDA device, x and w fp32 or bf16 of one type, K odd and <= 11,
    the residual (if any) of the output type. bf16 runs the tap GEMM on
    the tensor cores (after a reorder of the weights to [K, O, C] inside
    the same call), fp32 the CUDA-core kernel."""
    out_dtype = out_dtype or x.dtype
    tensors = tuple(v for v in (x, a, inv_b, weight, bias, residual)
                    if v is not None)
    kernels.forbid_grad("act_conv", *tensors)
    kernels.require_cuda("act_conv", *tensors)
    if x.dtype not in kernels.DTYPE_CODES or weight.dtype != x.dtype or \
            out_dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"act_conv: fp32 or bf16 x and w of one type and "
                        f"output, got {x.dtype}, {weight.dtype}, {out_dtype}")
    if x.dim() != 3 or weight.dim() != 3 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"act_conv: x {tuple(x.shape)} vs w "
                         f"{tuple(weight.shape)}")
    if not all(tt.is_contiguous() for tt in tensors):
        raise ValueError("act_conv: operands must be contiguous")
    b, c, t = x.shape
    o, _, k = weight.shape
    if k % 2 == 0 or k > 11 or dilation < 1:
        raise ValueError(f"act_conv: K={k} must be odd and <= 11, "
                         f"dilation={dilation}")
    for name, v, n in (("a", a, c), ("inv_b", inv_b, c), ("bias", bias, o)):
        if v is not None and (v.dtype != torch.float32 or v.shape != (n,)):
            raise ValueError(f"act_conv: {name} must be fp32 of shape ({n},)")
    if residual is not None and (residual.dtype != out_dtype
                                 or residual.shape != (b, o, t)):
        raise ValueError(f"act_conv: residual must be {out_dtype} of shape "
                         f"{(b, o, t)}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    wr = None
    if x.dtype == torch.bfloat16:
        # scratch for the weights reordered to [K, O, C padded to 8], which
        # the kernel indexes with 32-bit ints
        cp = -(-c // 8) * 8
        if k * o * cp >= 2 ** 31:
            raise ValueError(f"act_conv: weight {tuple(weight.shape)} too "
                             "large")
        wr = torch.empty((k, o, cp), dtype=x.dtype, device=x.device)
    y = torch.empty((b, o, t), dtype=out_dtype, device=x.device)
    taps = fused_taps()
    fn = kernels.function("act_conv", "ditto_act_conv", _ARGTYPES)
    err = fn(x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), weight.data_ptr(),
             None if wr is None else wr.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if residual is None else residual.data_ptr(), y.data_ptr(),
             taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
             b, c, t, o, k, dilation, kernels.DTYPE_CODES[x.dtype],
             kernels.DTYPE_CODES[out_dtype], kernels.stream_ptr(x))
    kernels.check(err, "act_conv")
    kernels.launches["act_conv"] += 1
    return y


def _too_short(t: int, ca: int, align: int) -> bool:
    """The Pallas wrappers' gate: T (rounded up to ``align``) shorter than
    the two-block halo of 2 * (ca + 8) rows, rounded the same way."""
    halo = -(-(2 * (ca + _AH)) // align) * align
    return -(-t // align) * align < halo


def _unfused(x, alpha, beta, weight, bias, dilation, logscale,
             compute_dtype):
    ca = (weight.shape[-1] - 1) * dilation // 2
    z = polyphase_anti_aliased_activation(
        x, lambda v: snake_beta(v, alpha, beta, logscale=logscale))
    return conv1d(F.pad(z, (ca, ca)), weight, bias, dilation=dilation,
                  compute_dtype=compute_dtype)


def _fused(x, alpha, beta, weight, bias, dilation, logscale, compute_dtype,
           residual=None):
    out_dtype = x.dtype
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
    xc = x.to(cdt).contiguous()
    wc = weight.to(cdt).contiguous()
    bc = None if bias is None else bias.float().contiguous()
    if residual is not None:
        residual = residual.to(out_dtype).contiguous()
    if x.device.type == "cpu":
        return aa_snake_conv1d_plain(xc, a, inv_b, wc, bc, dilation=dilation,
                                     residual=residual, out_dtype=out_dtype)
    return aa_snake_conv1d_cuda(xc, a.contiguous(), inv_b.contiguous(), wc,
                                bc, dilation=dilation, residual=residual,
                                out_dtype=out_dtype)


def aa_snake_conv1d(x, alpha, beta, weight, bias=None, *, dilation: int = 1,
                    logscale: bool = True,
                    compute_dtype: Optional[torch.dtype] = None):
    """x [B, C, T]; alpha / beta [C] (beta None: plain Snake); weight
    [O, C, K]. The 'SAME' conv of the anti-aliased Snake(Beta) of x,
    [B, O, T] in x's type."""
    ca = (weight.shape[-1] - 1) * dilation // 2
    if _too_short(x.shape[-1], ca, 16):
        return _unfused(x, alpha, beta, weight, bias, dilation, logscale,
                        compute_dtype)
    return _fused(x, alpha, beta, weight, bias, dilation, logscale,
                  compute_dtype)


def aa_snake_conv1d_ncl(x, alpha, beta, weight, bias=None, *,
                        dilation: int = 1, logscale: bool = True,
                        compute_dtype: Optional[torch.dtype] = None,
                        residual=None):
    """``aa_snake_conv1d`` plus ``residual`` [B, O, T] (the AMP block's
    ``x + conv2(act2(...))``), the time-minor Pallas twin's semantics:
    [B, O, T] in x's type."""
    ca = (weight.shape[-1] - 1) * dilation // 2
    if _too_short(x.shape[-1], ca, 128):
        out = _unfused(x, alpha, beta, weight, bias, dilation, logscale,
                       compute_dtype)
        return out if residual is None else out + residual
    return _fused(x, alpha, beta, weight, bias, dilation, logscale,
                  compute_dtype, residual)
