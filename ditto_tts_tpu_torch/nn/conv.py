"""1-D convolution helpers with torch semantics (the JAX ``nn/conv.py``).

Weight layouts are torch's: conv1d [out, in, k], conv_transpose1d
[in, out, k]. Every stride-1 conv goes to ``ops.conv.conv1d`` (kernel B on
the card); the strided SEANet down-convs and the codec's transposed convs
are ``F.conv1d`` / ``F.conv_transpose1d``, as the JAX package left them to
XLA. Includes the EnCodec causal/reflect padding helpers (HF
EncodecConv1d semantics) and the polyphase form of BigVGAN's upsample.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d


def pad1d(x, paddings, mode: str = "zero"):
    """Pad the last axis by (left, right). Reflect handles short inputs by
    zero-extending first (EnCodec edge-case semantics)."""
    left, right = paddings
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(left, right)
        extra = 0
        if length <= max_pad:
            extra = max_pad - length + 1
            x = F.pad(x, (0, extra))
        y = F.pad(x, (left, right), mode="reflect")
        if extra > 0:
            y = y[..., :y.shape[-1] - extra]
        return y
    return F.pad(x, (left, right))


def _extra_padding_for_conv1d(length, kernel_size, stride, padding_total):
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return max(ideal - length, 0)


def causal_conv1d(x, weight, bias=None, *, stride: int = 1, dilation: int = 1,
                  causal: bool = True):
    """EnCodec conv with causal/centered auto-padding (effective kernel
    (k-1)*d + 1, padding_total = eff_k - stride, plus extra right padding
    so the final frame is complete; causal puts padding_total left)."""
    k = weight.shape[-1]
    eff_k = (k - 1) * dilation + 1
    padding_total = eff_k - stride
    extra = _extra_padding_for_conv1d(x.shape[-1], eff_k, stride,
                                      padding_total)
    if causal:
        x = pad1d(x, (padding_total, extra), mode="reflect")
    else:
        right = padding_total // 2
        x = pad1d(x, (padding_total - right, right + extra), mode="reflect")
    if stride == 1:
        return conv1d(x, weight, bias, dilation=dilation)
    return F.conv1d(x, weight, bias, stride=stride, dilation=dilation)


def causal_conv_transpose1d(x, weight, bias=None, *, stride: int = 1,
                            causal: bool = True,
                            trim_right_ratio: float = 1.0):
    """EnCodec transposed conv: full output, then trim padding_total
    (causal: ceil(pt * trim_right_ratio) from the right, rest from left)."""
    k = weight.shape[-1]
    padding_total = k - stride
    y = F.conv_transpose1d(x, weight, bias, stride=stride)
    if causal:
        right = math.ceil(padding_total * trim_right_ratio)
        left = padding_total - right
    else:
        right = padding_total // 2
        left = padding_total - right
    return y[..., left:y.shape[-1] - right]


def _poly_weight(weight, r: int):
    """[I, O, K] transposed-conv weight -> [r*O, I, taps] forward-conv
    weight of the polyphase decomposition (taps = K // r): output channel
    p*O + o holds phase p, tap m reads x[u - (taps-1-m)]."""
    i, o, k = weight.shape
    taps = k // r
    w = weight.reshape(i, o, taps, r).flip(2)          # [I, O, m, p]
    return w.permute(3, 1, 0, 2).reshape(r * o, i, taps)


def conv_transpose1d_poly(x, weight, bias=None, *, stride: int = 1,
                          compute_dtype: Optional[torch.dtype] = None):
    """Transposed conv as ONE dense VALID conv (kernel B) + a phase
    interleave, equal to ``F.conv_transpose1d`` when K % stride == 0.
    x [N, C, L]; weight [I, O, K]; output length (L-1)*stride + K. The bias
    is added after the cast to x's type (the JAX package does the same)."""
    r = stride
    i, o, k = weight.shape
    if k % r != 0:
        raise ValueError(f"polyphase upsample needs K % stride == 0, got "
                         f"K={k}, stride={r} (BigVGAN uses K = 2*stride)")
    taps = k // r
    xp = F.pad(x, (taps - 1, taps - 1))
    y = conv1d(xp, _poly_weight(weight, r), None, compute_dtype=compute_dtype)
    n, _, u = y.shape
    # [N, r*O, U]: channel p*O + o -> [N, O, U*r] with time u*r + p
    y = y.reshape(n, r, o, u).permute(0, 2, 3, 1).reshape(n, o, u * r)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None]
    return y
