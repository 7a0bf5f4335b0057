"""The DiT block's elementwise glue: the plain versions and kernel E's
wrapper (``csrc/dit_glue.cu``).

Each function takes a GEMM's output before its bias (``torch.matmul``
against the weight, which ``nn.core.dense`` would follow with the bias add)
or an attention's output, and gives what the next GEMM or attention reads:

  add_norm(y, bias, res, norm) -> (x, xn)
      x = (y + bias) + res (no bias: y + res; no y: x = res); xn =
      ``nn.core.layer_norm(norm, x)`` (None where ``norm`` is None)
  qkv_rope(qkv, bias, nh, cos, sin) -> (q, k, v), each [B, nh, S, hd]
      the packed in_proj output [B, S, 3H] plus its bias, ``apply_rope`` on
      q and k
  bias_heads(y, bias, nh) -> [B, nh, S, hd]
      y plus its bias, split into heads (the cross-attention's q)
  gelu_gate(a, ba, g, bg) -> gelu(a + ba) * sigmoid(g + bg)

The plain versions are the eager ops of ``models/dit.py:dit_block``, in its
order and at its rounding points (every op rounds to the compute dtype;
layer_norm's statistics and affine are fp32). A CPU tensor takes them; a
CUDA tensor launches kernel E or raises (also, having no backward, on an
operand that requires grad under grad mode: ``kernels.forbid_grad``).
Kernel E computes each function in one pass and rounds where the plain
version does, so qkv_rope, bias_heads, gelu_gate and add_norm's x equal it
bit for bit; add_norm's xn sums its statistics in another order than
PyTorch's reductions and is within an ulp or so of the compute dtype.

``check_widths(hidden, head_dim, ff, dtype)`` raises ValueError naming the
first width of a DiT block that kernel E does not take: a row held in
registers (at most 6 x 32 16-byte vectors) and every width a whole number
of 16-byte vectors (a head's halves too).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..nn.core import layer_norm
from .rope import apply_rope

_MAX_VECS = 6   # 16-byte vectors a lane of add_norm holds (csrc/dit_glue.cu)
_EPS = 1e-5     # nn.core.layer_norm's


def _vec(dtype) -> int:
    return 16 // dtype.itemsize


def check_widths(hidden: int, head_dim: int, ff: int, dtype) -> None:
    """Raises ValueError unless kernel E takes a DiT block of these widths
    in ``dtype`` (fp32 or bf16)."""
    e = _vec(dtype)
    most = _MAX_VECS * 32 * e
    for what, ok, rule in (
            (f"hidden width {hidden}", hidden % e == 0 and hidden <= most,
             f"rows of whole 16-byte vectors ({e} elements) and of at most "
             f"{most} elements"),
            (f"head width {head_dim}",
             head_dim % (2 * e) == 0 and hidden % head_dim == 0,
             f"heads that divide the hidden width, each half of whole "
             f"16-byte vectors ({e} elements)"),
            (f"MLP width {ff}", ff % e == 0,
             f"rows of whole 16-byte vectors ({e} elements)")):
        if not ok:
            raise ValueError(f"kernel E takes no {what} in {dtype}: it "
                             f"needs {rule}")


def split_heads(x, nh: int):
    """[B, S, nh * hd] -> [B, nh, S, hd]."""
    b, s, h = x.shape
    return x.reshape(b, s, nh, h // nh).transpose(1, 2)


# ----------------------------------------------------------------- plain

def add_norm_plain(y, bias, res, norm):
    x = res if y is None else (y if bias is None else y + bias) + res
    return x, (None if norm is None else layer_norm(norm, x))


def qkv_rope_plain(qkv, bias, nh: int, cos, sin):
    q, k, v = (qkv + bias).chunk(3, dim=-1)
    b, s, h = q.shape
    hd = h // nh
    q = apply_rope(q.reshape(b, s, nh, hd), cos, sin).transpose(1, 2)
    k = apply_rope(k.reshape(b, s, nh, hd), cos, sin).transpose(1, 2)
    return q, k, split_heads(v, nh)


def bias_heads_plain(y, bias, nh: int):
    return split_heads(y + bias, nh)


def gelu_gate_plain(a, ba, g, bg):
    return F.gelu(a + ba) * torch.sigmoid(g + bg)


# ---------------------------------------------------------------- kernel E

def _rows(t, width: int, name: str):
    """t as [rows, width] with a unit inner stride (a view where t allows)
    and its row stride, in whole 16-byte vectors."""
    t2 = t.reshape(-1, width)
    if t2.stride(-1) != 1 or t2.stride(0) % _vec(t.dtype):
        raise ValueError(f"dit_glue: {name} needs a unit stride over its "
                         "last axis and rows 16-byte aligned")
    return t2, t2.stride(0)


def _check(name: str, dtype, *tensors):
    """Grad, device, one fp32 or bf16 type, 16-byte aligned storage."""
    kernels.forbid_grad("dit_glue", *tensors)
    present = [t for t in tensors if t is not None]
    kernels.require_cuda("dit_glue", *present)
    if dtype not in kernels.DTYPE_CODES or any(t.dtype != dtype
                                                 for t in present):
        raise TypeError(f"dit_glue {name}: fp32 or bf16 operands of one "
                        f"type, got {[t.dtype for t in present]}")
    if any(t.data_ptr() % 16 for t in present):
        raise ValueError(f"dit_glue {name}: every operand must be 16-byte "
                         "aligned")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _vector(t, n: int, name: str):
    if t is not None and (t.shape != (n,) or not t.is_contiguous()):
        raise ValueError(f"dit_glue: {name} must be contiguous of shape "
                         f"({n},), got {tuple(t.shape)}")
    return t


_ADD_NORM_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
    + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]


def add_norm_cuda(y, bias, res, norm):
    """Kernel E's add_norm; the operands of ``add_norm_plain`` on one CUDA
    device, in one type. x and xn come back dense in res's shape."""
    gamma = beta = None
    if norm is not None:
        gamma, beta = norm["weight"], norm["bias"]
    _check("add_norm", res.dtype, y, bias, res, gamma, beta)
    w = res.shape[-1]
    r2, rs = _rows(res, w, "res")
    y2, ys = (None, 0) if y is None else _rows(y, w, "y")
    if y2 is not None and y2.shape != r2.shape:
        raise ValueError(f"dit_glue: y {tuple(y.shape)} vs res "
                         f"{tuple(res.shape)}")
    for name, t in (("bias", bias), ("norm weight", gamma),
                    ("norm bias", beta)):
        _vector(t, w, name)
    x = None if y is None else torch.empty_like(r2)
    xn = None if norm is None else torch.empty_like(r2)
    fn = kernels.function("dit_glue", "ditto_add_norm", _ADD_NORM_ARGS)
    err = fn(_ptr(y2), _ptr(bias), r2.data_ptr(), _ptr(gamma), _ptr(beta),
             _ptr(x), _ptr(xn), r2.shape[0], w, ys, rs, _EPS,
             kernels.DTYPE_CODES[res.dtype], kernels.stream_ptr(res))
    kernels.check(err, "dit_glue add_norm")
    kernels.launches["dit_glue"] += 1
    x = res if x is None else x.view(res.shape)
    return x, (None if xn is None else xn.view(res.shape))


_QKV_ROPE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _heads_cuda(y, bias, nh: int, parts: int, rope: Optional[Tuple]):
    """Kernel E's qkv_rope mode: y [B, S, parts * H] plus bias [parts * H],
    RoPE on the first two parts where ``rope`` (cos, sin) is given; a tuple
    of ``parts`` [B, nh, S, hd] views of one dense [parts, B, S, H]."""
    cos, sin = rope if rope is not None else (None, None)
    _check("qkv_rope", y.dtype, y, bias, cos, sin)
    b, s, width = y.shape
    h = width // parts
    hd = h // nh
    y2, ys = _rows(y, width, "the GEMM output")
    _vector(bias, width, "bias")
    if rope is not None and any(t.shape != (s, hd) or not t.is_contiguous()
                                for t in rope):
        raise ValueError(f"dit_glue: RoPE tables must be contiguous "
                         f"({s}, {hd})")
    out = torch.empty((parts, b, s, h), dtype=y.dtype, device=y.device)
    fn = kernels.function("dit_glue", "ditto_qkv_rope", _QKV_ROPE_ARGS)
    err = fn(y2.data_ptr(), _ptr(bias), _ptr(cos), _ptr(sin),
             out.data_ptr(), b * s, s, parts, h, hd,
             0 if rope is None else 2, ys, kernels.DTYPE_CODES[y.dtype],
             kernels.stream_ptr(y))
    kernels.check(err, "dit_glue qkv_rope")
    kernels.launches["dit_glue"] += 1
    return tuple(split_heads(o, nh) for o in out.unbind(0))


def qkv_rope_cuda(qkv, bias, nh: int, cos, sin):
    return _heads_cuda(qkv, bias, nh, 3, (cos, sin))


def bias_heads_cuda(y, bias, nh: int):
    return _heads_cuda(y, bias, nh, 1, None)[0]


_GELU_GATE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
    + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]


def gelu_gate_cuda(a, ba, g, bg):
    _check("gelu_gate", a.dtype, a, ba, g, bg)
    n = a.shape[-1]
    if g.shape != a.shape:
        raise ValueError(f"dit_glue: gate {tuple(g.shape)} vs fc1 "
                         f"{tuple(a.shape)}")
    a2, as_ = _rows(a, n, "fc1")
    g2, gs = _rows(g, n, "gate")
    _vector(ba, n, "fc1 bias")
    _vector(bg, n, "gate bias")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    fn = kernels.function("dit_glue", "ditto_gelu_gate", _GELU_GATE_ARGS)
    err = fn(a2.data_ptr(), ba.data_ptr(), g2.data_ptr(), bg.data_ptr(),
             out.data_ptr(), a2.shape[0], n, as_, gs,
             kernels.DTYPE_CODES[a.dtype], kernels.stream_ptr(a))
    kernels.check(err, "dit_glue gelu_gate")
    kernels.launches["dit_glue"] += 1
    return out


# ------------------------------------------------------------- dispatchers

def add_norm(y, bias, res, norm):
    """(x, xn): see the module docstring; ``norm`` a LayerNorm's params
    ({"weight", "bias"}) or None for no norm."""
    if res.device.type == "cpu":
        return add_norm_plain(y, bias, res, norm)
    return add_norm_cuda(y, bias, res, norm)


def qkv_rope(qkv, bias, nh: int, cos, sin):
    if qkv.device.type == "cpu":
        return qkv_rope_plain(qkv, bias, nh, cos, sin)
    return qkv_rope_cuda(qkv, bias, nh, cos, sin)


def bias_heads(y, bias, nh: int):
    if y.device.type == "cpu":
        return bias_heads_plain(y, bias, nh)
    return bias_heads_cuda(y, bias, nh)


def gelu_gate(a, ba, g, bg):
    if a.device.type == "cpu":
        return gelu_gate_plain(a, ba, g, bg)
    return gelu_gate_cuda(a, ba, g, bg)
