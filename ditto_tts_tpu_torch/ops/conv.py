"""VALID, stride-1, dilated conv1d on [B, C, T]: plain version and kernel B.

``conv1d`` is the one entry point for every stride-1 conv of the SEANet
codec and of BigVGAN. A CPU tensor takes ``conv1d_plain`` (an explicit
K-tap sum of fp32 products); a CUDA tensor launches kernel B
(``csrc/conv1d.cu``, the port of the Pallas ``conv1d_nlc_pallas`` and
``conv1d_ncl_pallas``: a tap-sum implicit GEMM on the tensor cores in bf16,
exact fp32 on the CUDA cores in fp32) or raises.

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


_ARGTYPES_F32 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_BF16 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def conv1d_cuda(x, weight, bias=None, *, dilation: int = 1):
    """Kernel B. x [B, C, T] and w [O, C, K] contiguous, of one type (fp32
    or bf16), K <= 11; bias [O] fp32 or None. Returns [B, O, T-(K-1)*dil]
    in x's type. bf16 runs the tensor-core kernel (after a reorder of the
    weights to [K, O, C] inside the same call), fp32 the CUDA-core one."""
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
    bias_ptr = None if bias is None else bias.data_ptr()
    if x.dtype == torch.bfloat16:
        # scratch for the weights reordered to [K, O, C padded to 8], which
        # the kernel indexes with 32-bit ints
        cp = -(-c // 8) * 8
        if k * o * cp >= 2 ** 31:
            raise ValueError(f"conv1d: weight {tuple(weight.shape)} too large")
        wr = torch.empty((k, o, cp), dtype=x.dtype, device=x.device)
        fn = kernels.function("conv1d", "ditto_conv1d_bf16", _ARGTYPES_BF16)
        err = fn(x.data_ptr(), weight.data_ptr(), wr.data_ptr(), bias_ptr,
                 y.data_ptr(), b, c, t_in, o, k, dilation,
                 kernels.stream_ptr(x))
    else:
        fn = kernels.function("conv1d", "ditto_conv1d_f32", _ARGTYPES_F32)
        err = fn(x.data_ptr(), weight.data_ptr(), bias_ptr, y.data_ptr(),
                 b, c, t_in, o, k, dilation, kernels.stream_ptr(x))
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


def conv1d_ncl_batched(x, weight, bias=None, *, dilation: int = 1,
                       compute_dtype: Optional[torch.dtype] = None):
    """The counterpart of the Pallas ``conv1d_ncl_batched_pallas``: a VALID
    stride-1 conv of x [B, C, T] with the whole batch in one launch, on
    kernel B (a block of kernel B owns one batch row's tile, and one launch
    covers every row).

    The Pallas kernel multiplied a block-diagonal [B*O, K*B*C] weight into
    a [K*B*C, block] window so that the batch filled the TPU's 128-row
    matrix unit; its docstring measured no gain over the per-batch kernel
    (3.21 vs 2.94 ms at B=8, C=32, T=240k, fp32, K=3). On the H100 that
    expansion would only multiply the work by B. The JAX wrapper's gates
    stay as far as they show in the result: its batch gate (B == 1, B*C or
    B*O not a multiple of 8, B*C > 1024, K*B*C > 4096) picks the per-batch
    Pallas kernel, which computes the same function, here kernel B as well;
    without ``compute_dtype`` the operands promote to a common type; and a
    T too short for the two-block halo runs the JAX fallback conv, which
    returns the promoted type where the kernels return x's."""
    if compute_dtype is None:
        compute_dtype = torch.promote_types(x.dtype, weight.dtype)
    k = weight.shape[-1]
    halo = max(-(-((k - 1) * dilation) // 128) * 128, 128)
    t_out = x.shape[-1] - (k - 1) * dilation
    if -(-t_out // 128) * 128 < halo:
        x = x.to(compute_dtype)     # the result then has the promoted type
    return conv1d(x, weight, bias, dilation=dilation,
                  compute_dtype=compute_dtype)
