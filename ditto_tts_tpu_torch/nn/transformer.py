"""Post-LN transformer decoder with torch.nn.TransformerDecoder semantics
(the JAX package's ``nn/transformer.py``), the SLP's decoder: causal
self-attention, cross-attention to the ByT5 memory, ReLU feed-forward,
post-norm with LN eps 1e-5, packed MHA ``in_proj`` layout.

Attention by head width: a head wider than 128 takes the fp32
matmul-softmax math (``attention_plain``, the counterpart of JAX's
``sdpa_reference``), as JAX sends it there on every platform
(``ops/attention.py:295-299``: the Pallas kernels stop at head_dim 128);
any other head calls ``attention``, so kernel A on the card. The SLP's
one head of 1472 is the first case.

Tensor parallelism (``mesh``, None for none), as in ``models/dit.py``: an
MHA whose packed in_proj holds a share of the heads runs them between
``parallel/tp.py``'s ``copy_to_model`` and a row-parallel out_proj; under
a model axis above 1 the feed-forward splits (linear1 column-parallel,
linear2 row-parallel). The SLP's one head stays whole on every rank.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.attention import attention, attention_plain
from ..parallel.tp import copy_to_model, row_parallel
from .core import dense, layer_norm

MAX_KERNEL_HEAD_DIM = 128


def _mha_apply(params, num_heads: int, q_in, kv_in, *, causal=False,
               mesh=None):
    w = params["in_proj_weight"]
    b = params["in_proj_bias"]
    full = q_in.shape[-1]
    h = w.shape[0] // 3                 # this rank's share under a mesh
    split = h != full
    if split:
        num_heads = num_heads * h // full
        q_in, kv_in = ((copy_to_model(q_in, mesh),) * 2 if kv_in is q_in
                       else (copy_to_model(q_in, mesh),
                             copy_to_model(kv_in, mesh)))
    q = dense({"weight": w[:h], "bias": b[:h]}, q_in)
    k = dense({"weight": w[h:2 * h], "bias": b[h:2 * h]}, kv_in)
    v = dense({"weight": w[2 * h:], "bias": b[2 * h:]}, kv_in)

    def heads(x):
        bsz, s, _ = x.shape
        return x.reshape(bsz, s, num_heads, h // num_heads).transpose(1, 2)

    attend = attention if h // num_heads <= MAX_KERNEL_HEAD_DIM \
        else attention_plain
    out = attend(heads(q), heads(k), heads(v), causal=causal)
    bsz, _, s, _ = out.shape
    out = out.transpose(1, 2).reshape(bsz, s, h)
    return (row_parallel(params["out_proj"], out, mesh) if split
            else dense(params["out_proj"], out))


def transformer_decoder_layer(params: Dict, nhead: int, x, memory, *,
                              causal_self: bool = True, mesh=None):
    """One ``TransformerDecoderLayer``: x = LN(x + sublayer(x)) three times
    (causal self-attention, cross-attention to memory, ReLU FF)."""
    sa = _mha_apply(params["self_attn"], nhead, x, x, causal=causal_self,
                    mesh=mesh)
    x = layer_norm(params["norm1"], x + sa)
    ca = _mha_apply(params["cross_attn"], nhead, x, memory, mesh=mesh)
    x = layer_norm(params["norm2"], x + ca)
    if mesh is not None and mesh.model > 1:
        ff = row_parallel(params["linear2"], torch.relu(dense(
            params["linear1"], copy_to_model(x, mesh))), mesh)
    else:
        ff = dense(params["linear2"], torch.relu(dense(params["linear1"],
                                                       x)))
    return layer_norm(params["norm3"], x + ff)


def transformer_decoder(layers: List[Dict], nhead: int, x, memory, *,
                        causal_self: bool = True, mesh=None):
    """``TransformerDecoder``: the layers in order (no final norm)."""
    for p in layers:
        x = transformer_decoder_layer(p, nhead, x, memory,
                                      causal_self=causal_self, mesh=mesh)
    return x
