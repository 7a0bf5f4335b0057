"""Attention over [B, H, S, D]: the plain version and kernel A's wrapper.

``attention`` is the one entry point. A CPU tensor takes ``attention_plain``
(explicit fp32-softmax math, the counterpart of the JAX package's
``sdpa_reference``); a CUDA tensor launches kernel A
(``csrc/attention.cu``, the port of the Pallas ``pallas_attention`` and
``pallas_attention_packed``: flash attention on the tensor cores in bf16,
exact fp32 on the CUDA cores in fp32) or raises. There is no length
switch: on the card every call, self or cross, at every length, is the
kernel. Kernel A takes heads of 64 and 128; ``attention`` zero-pads a
narrower head to the next of them (the scale stays that of the true
width, and the padded output columns are dropped), as JAX's
``pallas_attention`` pads every head to 128, so the tiny configurations
(heads of 16) run on kernel A too. Attention that JAX never sends to
Pallas (heads wider than 128, an additive bias: the SLP decoder and ByT5)
calls ``attention_plain`` directly, on any device.

Training differentiates through ``attention``: where grad mode is on and an
operand requires grad, it runs ``_Attention``, an ``autograd.Function``
whose forward is the same call (kernel A on the card) and whose backward
is ``attention_backward``, the JAX ``_pallas_attn_bwd`` math in stock ops
(fp32 recompute of the probabilities, then the softmax-attention
gradient), as the JAX ``custom_vjp`` pairs the Pallas forward with an
``einsum`` backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels


def _acc_dtype(q):
    """fp32 sums for bf16 and fp32 operands (fp64 ones keep fp64, for
    gradient checks)."""
    return torch.promote_types(q.dtype, torch.float32)


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
    acc = _acc_dtype(q)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
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
    return torch.matmul(p.to(acc), v.to(acc)).to(q.dtype)


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


KERNEL_HEAD_DIMS = (64, 128)


def head_padded(fn, q, k, v, causal, sm_scale, kv_len):
    """``fn`` (kernel A's wrapper) on q, k and v zero-padded along the head
    dim to the next of ``KERNEL_HEAD_DIMS``, at the unpadded width's
    scale; the output cut back. Zero columns add nothing to Q K^T, and V's
    zero columns give the output columns that are dropped."""
    d = q.shape[-1]
    dp = next(n for n in KERNEL_HEAD_DIMS if n >= d)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    return fn(q, k, v, causal=causal, sm_scale=scale, kv_len=kv_len)[
        ..., :d]


def _forward(q, k, v, causal, sm_scale, kv_len):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len)
    if q.shape[-1] < KERNEL_HEAD_DIMS[-1] and \
            q.shape[-1] not in KERNEL_HEAD_DIMS:
        return head_padded(attention_cuda, q, k, v, causal, sm_scale, kv_len)
    return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                          kv_len=kv_len)


def attention_backward(q, k, v, g, *, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       kv_len: Optional[int] = None):
    """(dq, dk, dv) of softmax(Q K^T * scale) V for the output gradient g
    (the JAX ``ops/attention.py:_pallas_attn_bwd``): fp32 scores, masked
    keys (causal, index >= ``kv_len``) at -1e30, P by softmax, dV = P^T g,
    dP = g V^T, dS = P (dP - rowsum(dP P)), dQ = dS K scale, dK = dS^T Q
    scale, each cast back to its operand's type."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    acc = _acc_dtype(q)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    sq, sk = s.shape[-2:]
    mask = None
    if kv_len is not None and kv_len < sk:
        mask = torch.arange(sk, device=q.device)[None, :] < kv_len
    if causal:
        cm = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        mask = cm if mask is None else mask & cm
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """Kernel A (the plain version on the CPU) forward, the JAX custom-VJP
    backward (``attention_backward``). Saves q, k and v, not the
    probabilities: the backward recomputes them, as JAX's does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
        return _forward(q, k, v, causal, sm_scale, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, g, **ctx.opts), None, None,
                None)


def attention(q, k, v, *, causal: bool = False,
              sm_scale: Optional[float] = None,
              kv_len: Optional[int] = None):
    """Multi-head attention over [B, H, S, D]: the plain version for a CPU
    tensor, kernel A for a CUDA tensor; differentiable (``_Attention``)
    where grad mode is on and an operand requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, sm_scale, kv_len)
    return _forward(q, k, v, causal, sm_scale, kv_len)
