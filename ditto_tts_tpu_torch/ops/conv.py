"""VALID, stride-1, dilated conv1d on [B, C, T]: plain version and kernel B.

``conv1d`` is the one entry point for every stride-1 conv of the SEANet
codec and of BigVGAN. A CPU tensor takes ``conv1d_plain`` (an explicit
K-tap sum of fp32 products); a CUDA tensor launches kernel B
(``csrc/conv1d.cu``, the port of the Pallas ``conv1d_nlc_pallas`` and
``conv1d_ncl_pallas``) or raises.

Dtype contract (the JAX package's ``nn/conv.py``): both operands are cast
to ``compute_dtype`` (default: x's type), products sum in fp32, the fp32
bias joins the sum before the single cast to x's type.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

MAX_TAPS = 11


def conv1d_plain(x, weight, bias=None, *, dilation: int = 1):
    """y[b, o, t] = bias[o] + sum_{c,k} w[o, c, k] x[b, c, t + k*dilation],
    summed in fp32, returned in x's type."""
    k = weight.shape[-1]
    t_out = x.shape[-1] - (k - 1) * dilation
    xf, wf = x.float(), weight.float()
    acc = None
    for m in range(k):
        ym = torch.matmul(wf[:, :, m], xf[..., m * dilation:m * dilation + t_out])
        acc = ym if acc is None else acc + ym
    if bias is not None:
        acc = acc + bias.float()[None, :, None]
    return acc.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def conv1d_cuda(x, weight, bias=None, *, dilation: int = 1):
    """Kernel B. x [B, C, T] and w [O, C, K] contiguous, of one type (fp32
    or bf16), K <= 11; bias [O] fp32 or None. Returns [B, O, T-(K-1)*dil]
    in x's type."""
    tensors = (x, weight) if bias is None else (x, weight, bias)
    kernels.require_cuda("conv1d", *tensors)
    if x.dtype not in kernels.DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"conv1d: fp32 or bf16 x and w of one type, got "
                        f"{x.dtype}, {weight.dtype}")
    if x.dim() != 3 or weight.dim() != 3 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"conv1d: x {tuple(x.shape)} vs w {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("conv1d: x and w must be contiguous")
    b, c, t_in = x.shape
    o, _, k = weight.shape
    if not 1 <= k <= MAX_TAPS or dilation < 1:
        raise ValueError(f"conv1d: K={k} (max {MAX_TAPS}), dilation={dilation}")
    t_out = t_in - (k - 1) * dilation
    if t_out <= 0:
        raise ValueError(f"conv1d: input length {t_in} too short for K={k}, "
                         f"dilation={dilation}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (o,)
                             or not bias.is_contiguous()):
        raise ValueError("conv1d: bias must be a contiguous fp32 [O] tensor")
    y = torch.empty((b, o, t_out), dtype=x.dtype, device=x.device)
    fn = kernels.function("conv1d", "ditto_conv1d", _ARGTYPES)
    err = fn(x.data_ptr(), weight.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             b, c, t_in, o, k, dilation, kernels.DTYPE_CODES[x.dtype],
             kernels.stream_ptr(x))
    kernels.check(err, "conv1d")
    kernels.launches["conv1d"] += 1
    return y


def conv1d(x, weight, bias=None, *, dilation: int = 1,
           compute_dtype: Optional[torch.dtype] = None):
    """VALID stride-1 conv: the plain version for a CPU tensor, kernel B for
    a CUDA tensor. Operands cast to ``compute_dtype``; result in x's type."""
    out_dtype = x.dtype
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    xc = x.to(cdt).contiguous()
    wc = weight.to(cdt).contiguous()
    bc = None if bias is None else bias.float().contiguous()
    if x.device.type == "cpu":
        y = conv1d_plain(xc, wc, bc, dilation=dilation)
    else:
        y = conv1d_cuda(xc, wc, bc, dilation=dilation)
    return y.to(out_dtype)
