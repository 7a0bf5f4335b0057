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

An autoregressive model decoding over a KV cache (VALL-E,
``infer/kv_cache.py``) takes two more options, bf16 on the card: a
``prefix`` (with ``causal``, keys before it are visible to every row: the
prefix-LM mask) and ``kv_lens``, the key length as an int32 tensor on the
device, one or one a batch row, which a captured graph reads at every
replay. A call with ``kv_lens`` and one query a row that is not causal is
the decode launch (``kv_decode_kernel``, counted as ``kv_decode``); any
other call with either option is A's masked launch. Calls that give
neither launch A exactly as before.

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
                    kv_len: Optional[int] = None, bias=None,
                    prefix: int = 0, kv_lens=None):
    """softmax(Q K^T * scale + bias) V with fp32 scores and softmax; the
    probabilities are cast to v's type before the fp32-summed PV product
    (the JAX ``sdpa_reference`` and Pallas kernels do the same). Keys at
    index >= ``kv_len`` are masked, or, where ``kv_lens`` (an int tensor
    of one length or one a batch row) is given, >= its length. Causal
    masks the keys after the row but the first ``prefix``. ``bias`` (fp32,
    broadcast to [B, H, Sq, Sk]) is additive; kernel A takes none, so a
    call with a bias is always this math, as in JAX
    (``ops/attention.py:300``)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    acc = _acc_dtype(q)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    sq, sk = scores.shape[-2:]
    mask = None
    if kv_lens is not None:
        mask = torch.arange(sk, device=q.device) \
            < kv_lens.reshape(-1, 1, 1, 1).to(q.device)
    elif kv_len is not None and kv_len < sk:
        mask = torch.arange(sk, device=q.device)[None, :] < kv_len
    if causal:
        kc = torch.arange(sk, device=q.device)[None, :]
        cm = (kc <= torch.arange(sq, device=q.device)[:, None]) | \
            (kc < prefix)
        mask = cm if mask is None else mask & cm
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(p.to(acc), v.to(acc)).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_MASKED_ARGTYPES = [ctypes.c_void_p] * 4 \
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_void_p]
_DECODE_ARGTYPES = [ctypes.c_void_p] * 4 \
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _device_lengths(kv_lens, b: int, dev):
    """(pointer, stride over the batch rows) of an int32 length tensor of
    one length or one a row, on ``dev``."""
    if kv_lens.dtype != torch.int32 or kv_lens.device != dev \
            or kv_lens.numel() not in (1, b) or not kv_lens.is_contiguous():
        raise ValueError(f"attention: kv_lens must be a contiguous int32 "
                         f"tensor of 1 or {b} lengths on {dev}, got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)} on "
                         f"{kv_lens.device}")
    return kv_lens.data_ptr(), 0 if kv_lens.numel() == 1 else 1


def attention_cuda(q, k, v, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   kv_len: Optional[int] = None, prefix: int = 0,
                   kv_lens=None):
    """Kernel A. q [B, H, Sq, D], k/v [B, H, Sk, D] on one CUDA device,
    fp32 or bf16, D in {64, 128}, any strides over (b, h, s) with a unit
    stride over d; in bf16 (the tensor-core kernel, fed by 16-byte
    asynchronous copies) every operand 16-byte aligned with (b, h, s)
    strides that are multiples of 8. Returns [B, H, Sq, D] as a view of a
    [B, Sq, H, D] buffer, so merging heads after it is free. ``prefix``
    and ``kv_lens`` (see the module docstring) take bf16 operands; with
    ``kv_lens`` the host ``kv_len`` is not read."""
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
    if prefix or kv_lens is not None:
        return _masked(q, k, v, o, strides, causal, prefix, kv_lens, kvl,
                       scale)
    fn = kernels.function("attention", "ditto_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
             b, h, sq, sk, d, kvl, int(causal), scale,
             kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q))
    kernels.check(err, "attention")
    kernels.launches["attention"] += 1
    return o


def _masked(q, k, v, o, strides, causal, prefix, kv_lens, kvl, scale):
    """A's masked launch, or the decode launch (``kv_lens`` given, one
    query, not causal), into o."""
    if q.dtype != torch.bfloat16:
        raise TypeError("attention: prefix and kv_lens take bf16 operands")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if not 0 <= prefix <= sk:
        raise ValueError(f"attention: prefix {prefix} outside [0, {sk}]")
    ptr, stride = (None, 0) if kv_lens is None else _device_lengths(
        kv_lens, b, q.device)
    stream = kernels.stream_ptr(q)
    if kv_lens is not None and sq == 1 and not causal:
        fn = kernels.function("attention", "ditto_kv_decode",
                              _DECODE_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 strides, b, h, sk, d, kvl, ptr, stride, scale, stream)
        kernels.check(err, "attention (decode)")
        kernels.launches["kv_decode"] += 1
        return o
    fn = kernels.function("attention", "ditto_attention_masked",
                          _MASKED_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
             b, h, sq, sk, d, kvl, ptr, stride, int(causal), int(prefix),
             scale, stream)
    kernels.check(err, "attention (masked)")
    kernels.launches["attention"] += 1
    return o


KERNEL_HEAD_DIMS = (64, 128)


def head_padded(fn, q, k, v, causal, sm_scale, kv_len, **masks):
    """``fn`` (kernel A's wrapper) on q, k and v zero-padded along the head
    dim to the next of ``KERNEL_HEAD_DIMS``, at the unpadded width's
    scale; the output cut back. Zero columns add nothing to Q K^T, and V's
    zero columns give the output columns that are dropped."""
    d = q.shape[-1]
    dp = next(n for n in KERNEL_HEAD_DIMS if n >= d)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    return fn(q, k, v, causal=causal, sm_scale=scale, kv_len=kv_len,
              **masks)[..., :d]


def _forward(q, k, v, causal, sm_scale, kv_len, **masks):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len, **masks)
    if q.shape[-1] < KERNEL_HEAD_DIMS[-1] and \
            q.shape[-1] not in KERNEL_HEAD_DIMS:
        return head_padded(attention_cuda, q, k, v, causal, sm_scale, kv_len,
                           **masks)
    return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                          kv_len=kv_len, **masks)


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
              kv_len: Optional[int] = None, prefix: int = 0, kv_lens=None):
    """Multi-head attention over [B, H, S, D]: the plain version for a CPU
    tensor, kernel A for a CUDA tensor; differentiable (``_Attention``)
    where grad mode is on and an operand requires grad (``prefix`` and
    ``kv_lens``, see the module docstring, serve inference only)."""
    masks = {}
    if prefix or kv_lens is not None:
        masks = dict(prefix=prefix, kv_lens=kv_lens)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if masks:
            raise ValueError("attention: prefix and kv_lens have no "
                             "backward")
        return _Attention.apply(q, k, v, causal, sm_scale, kv_len)
    return _forward(q, k, v, causal, sm_scale, kv_len, **masks)
