"""The ByT5 (T5 v1.1) encoder, the SLP's text encoder (the JAX package's
``text/byt5.py``; HF-weight compatible).

  * RMS norm (no mean subtraction), weight only, pre-norm blocks; the
    normalized value is cast to x's type before the weight multiplies it;
  * self-attention without 1/sqrt(d), fp32 scores plus the shared relative
    position bias of block 0 (and the padding mask as -1e9), probabilities
    cast to v's type: ``ops.attention.attention_plain`` with a bias, as the
    JAX encoder computes it inline with no Pallas kernel;
  * gated-GELU feed-forward (wi_0 through gelu_new, times wi_1, then wo);
    no biases anywhere.

byt5-small: vocab 384, d_model 1472, d_ff 3584, 12 layers, 6 heads of 64,
32 buckets up to distance 128.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ByT5Config, byt5_small_config  # noqa: F401 (re-export)
from ..nn.core import dense
from ..ops.attention import attention_plain
from .gpt2 import gelu_new


def rms_norm(weight, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _relative_position_bucket(relative_position, num_buckets=32,
                              max_distance=128):
    """T5 bidirectional bucketing, in numpy float64 on the host as in JAX
    (a float32 log moves some distances into the next bucket)."""
    rp = relative_position
    num_buckets //= 2
    ret = (rp > 0).astype(np.int64) * num_buckets
    rp = np.abs(rp)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, rp, large)


def position_bias(params, cfg: ByT5Config, seq_len: int):
    """[1, heads, S, S] additive bias from block 0's relative embedding."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    buckets = _relative_position_bucket(
        mem - ctx, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    table = params["relative_attention_bias"]["weight"]  # [buckets, heads]
    bias = table[torch.from_numpy(buckets).to(table.device)]  # [S, S, heads]
    return bias.permute(2, 0, 1)[None]


def _self_attn(p, cfg: ByT5Config, x, bias):
    b, s, _ = x.shape
    nh, dk = cfg.num_heads, cfg.d_kv

    def heads(name):
        return dense(p[name], x).reshape(b, s, nh, dk).transpose(1, 2)

    out = attention_plain(heads("q"), heads("k"), heads("v"), sm_scale=1.0,
                          bias=bias)    # T5: no 1/sqrt(d)
    return dense(p["o"], out.transpose(1, 2).reshape(b, s, nh * dk))


def byt5_encode(params, cfg: ByT5Config, input_ids, attention_mask=None):
    """input_ids: [B, S] -> last hidden state [B, S, d_model]."""
    x = params["shared"]["weight"][input_ids]
    bias = position_bias(params["block0_rel"], cfg, input_ids.shape[1])
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float()) * -1e9
        bias = bias + pad[:, None, None, :]

    for blk in params["blocks"]:
        h = rms_norm(blk["attn_norm"]["weight"], x, cfg.layer_norm_epsilon)
        x = x + _self_attn(blk["attn"], cfg, h, bias)
        h = rms_norm(blk["ff_norm"]["weight"], x, cfg.layer_norm_epsilon)
        ff = blk["ff"]
        gated = gelu_new(dense(ff["wi_0"], h)) * dense(ff["wi_1"], h)
        x = x + dense(ff["wo"], gated)

    return rms_norm(params["final_norm"]["weight"], x,
                    cfg.layer_norm_epsilon)


def import_hf_state_dict(sd: Dict[str, np.ndarray],
                         cfg: ByT5Config) -> Dict:
    """Map an HF T5EncoderModel state_dict (numpy arrays) to params."""
    def w(name):
        return {"weight": torch.from_numpy(np.array(sd[name], copy=True))}

    blocks = []
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}"
        attn = f"{b}.layer.0.SelfAttention"
        ff = f"{b}.layer.1.DenseReluDense"
        blocks.append({
            "attn": {n: w(f"{attn}.{n}.weight") for n in ("q", "k", "v", "o")},
            "attn_norm": w(f"{b}.layer.0.layer_norm.weight"),
            "ff": {n: w(f"{ff}.{n}.weight") for n in ("wi_0", "wi_1", "wo")},
            "ff_norm": w(f"{b}.layer.1.layer_norm.weight"),
        })
    return {
        "shared": w("shared.weight"),
        "block0_rel": {"relative_attention_bias": w(
            "encoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight")},
        "blocks": blocks,
        "final_norm": w("encoder.final_layer_norm.weight"),
    }
