"""Functional NN primitives with the JAX package's conventions.

Params are plain dicts of tensors in torch layout:
  * dense: ``y = x @ W.T + b`` with W [out, in]; the product sums in fp32
    (``torch.matmul``) and is cast to x's type before the bias is added;
  * layer_norm: biased variance, eps inside the sqrt, statistics in fp32,
    non-affine when the params are empty;
  * embed: a table lookup, table [num, dim].
"""

from __future__ import annotations

import torch


def dense(params, x):
    """``x @ W.T + b`` with torch-layout W [out, in]."""
    y = torch.matmul(x, params["weight"].t())
    b = params.get("bias")
    if b is not None:
        y = y + b
    return y


def layer_norm(params, x, *, eps: float = 1e-5):
    """torch.nn.LayerNorm over the last axis; statistics in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if params and "weight" in params:
        y = y * params["weight"].float() + params["bias"].float()
    return y.to(x.dtype)


def embed(params, ids):
    return params["weight"][ids]
