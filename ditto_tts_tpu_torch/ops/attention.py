"""Attention over [B, H, S, D]: the plain version and kernel A's wrapper.

``attention`` is the one entry point. A CPU tensor takes ``attention_plain``
(explicit fp32-softmax math, the counterpart of the JAX package's
``sdpa_reference``); a CUDA tensor launches kernel A
(``csrc/attention.cu``, the port of the Pallas ``pallas_attention`` and
``pallas_attention_packed``: flash attention on the tensor cores in bf16,
exact fp32 on the CUDA cores in fp32) or raises. There is no length
switch: on the card every call, self or cross, at every length, is the
kernel. Attention that JAX never sends to Pallas (heads wider than 128, an
additive bias: the SLP decoder and ByT5) calls ``attention_plain``
directly, on any device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels


def attention_plain(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None, bias=None):
    """softmax(Q K^T * scale + bias) V with fp32 scores and softmax; the
    probabilities are cast to v's type before the fp32-summed PV product
    (the JAX ``sdpa_reference`` and Pallas kernels do the same). Keys at
    index >= ``kv_len`` are masked. ``bias`` (fp32, broadcast to
    [B, H, Sq, Sk]) is additive; kernel A takes none, so a call with a
    bias is always this math, as in JAX (``ops/attention.py:300``)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    sq, sk = scores.shape[-2:]
    mask = None
    if kv_len is not None and kv_len < sk:
        mask = torch.arange(sk, device=q.device)[None, :] < kv_len
    if causal:
        cm = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        mask = cm if mask is None else mask & cm
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def attention_cuda(q, k, v, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   kv_len: Optional[int] = None):
    """Kernel A. q [B, H, Sq, D], k/v [B, H, Sk, D] on one CUDA device,
    fp32 or bf16, D in {64, 128}, any strides over (b, h, s) with a unit
    stride over d; in bf16 (the tensor-core kernel, fed by 16-byte
    asynchronous copies) every operand 16-byte aligned with (b, h, s)
    strides that are multiples of 8. Returns [B, H, Sq, D] as a view of a
    [B, Sq, H, D] buffer, so merging heads after it is free."""
    kernels.require_cuda("attention", q, k, v)
    if q.dtype not in kernels.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"attention: fp32 or bf16 operands of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"attention: head_dim {d} not in (64, 128)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention: the head dim must have unit stride")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("attention: bf16 operands must be 16-byte aligned "
                         "with (b, h, s) strides that are multiples of 8")
    kvl = sk if kv_len is None else int(kv_len)
    if not 1 <= kvl <= sk:
        raise ValueError(f"attention: kv_len {kvl} outside [1, {sk}]")
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o) for s in t.stride()[:3]])
    fn = kernels.function("attention", "ditto_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
             b, h, sq, sk, d, kvl, int(causal), scale,
             kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q))
    kernels.check(err, "attention")
    kernels.launches["attention"] += 1
    return o


def attention(q, k, v, *, causal: bool = False,
              sm_scale: Optional[float] = None,
              kv_len: Optional[int] = None):
    """Multi-head attention over [B, H, S, D]: the plain version for a CPU
    tensor, kernel A for a CUDA tensor."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len)
    return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                          kv_len=kv_len)
