"""Precisions of the plain reference, and its lower-precision control.

Every matrix product and convolution of the reference goes through this
module. ``"float32"`` multiplies in fp32 with TF32 off (``exact()`` turns
PyTorch's TF32 switches off for the reference and back afterwards). The
lower precisions round both operands of each product to the format and
sum in fp32, as the tensor cores do: ``"tf32"`` to a 10-bit mantissa,
``"bfloat16"`` to bf16, ``"fp8"`` to e4m3 with one scale per operand
(its largest magnitude mapped to 448).

``control_of`` gives the control's precision for a part from the one the
configuration states: TF32 for float32 that runs with TF32 off, bfloat16
for other float32 (``"float32+tf32"``: fp32 tensors whose cuDNN
convolutions run in TF32, PyTorch's default), fp8 for bfloat16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def control_of(stated: str) -> str:
    return {"float32": "tf32", "float32+tf32": "bfloat16",
            "bfloat16": "fp8"}[stated]


def controls(stated: dict) -> dict:
    """The control's precision of every part of a configuration's
    ``precision`` map. A carry (``*_carry``: the type activations are kept
    in between products) below fp32 goes one step lower, as the products
    do; an fp32 carry stays fp32 (TF32 is a product's precision)."""
    out = {}
    for part, p in stated.items():
        if part.endswith("_carry"):
            out[part] = control_of(p) if p == "bfloat16" else p
        else:
            out[part] = control_of(p)
    return out


@contextlib.contextmanager
def exact():
    """fp32 products without TF32, restoring the caller's switches."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _tf32(x):
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF                    # round to 10 mantissa bits
    return i.view(torch.float32)


def _round(x, prec: str):
    if prec == "tf32":
        return _tf32(x)
    if prec == "bfloat16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        s = FP8_MAX / x.abs().amax().clamp(min=1e-30)
        return (x * s).to(torch.float8_e4m3fn).float() / s
    raise ValueError(f"unknown precision {prec!r}")


def rnd(x, prec: str):
    """x (fp32) rounded to ``prec``, returned in fp32; a gradient passes
    through the rounding unchanged."""
    x = x.float()
    if prec in ("float32", None):
        return x
    r = _round(x.detach(), prec)
    return x + (r - x).detach() if x.requires_grad else r


def matmul(a, b, prec: str):
    return torch.matmul(rnd(a, prec), rnd(b, prec))


def linear(p, x, prec: str):
    """x @ W^T + b with W [out, in]."""
    y = matmul(x, p["weight"].t(), prec)
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y


def conv1d(x, w, b=None, *, prec: str, stride: int = 1, dilation: int = 1,
           padding: int = 0, groups: int = 1):
    return F.conv1d(rnd(x, prec), rnd(w, prec),
                    None if b is None else b.float(), stride=stride,
                    dilation=dilation, padding=padding, groups=groups)


def conv_transpose1d(x, w, b=None, *, prec: str, stride: int = 1,
                     padding: int = 0, groups: int = 1):
    return F.conv_transpose1d(rnd(x, prec), rnd(w, prec),
                              None if b is None else b.float(),
                              stride=stride, padding=padding, groups=groups)
