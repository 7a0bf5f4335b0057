"""DiT diffusion transformer (the JAX package's ``models/dit.py``).

  * GlobalAdaLN: time+text conditioned scale/shift applied once before the
    block stack (``scale = 1 + time_scale + text_scale``, mean-pooled text,
    non-affine LN).
  * DiTBlock: self-attention with RoPE, cross-attention to the text, gated
    MLP (exact GELU times a sigmoid gate).
  * DiTTO: timestep embedding + SiLU MLP, the shared GlobalAdaLN, N blocks
    and a long skip through proj_in/proj_out.

``ref_compat`` (quirk #2) skips the self-attention ``out_proj``. Inference
only: the train-time cross-attention dropout belongs to the training port.

Per-request work is hoisted out of the denoising loop by ``prepare``: the
block parameters are cast to the compute dtype once (the JAX
``prepare_blocks``), every layer's cross-attention K/V is projected from
the text once (``prepare_cross_kv``) and the RoPE tables are built once.
The block stack is a Python loop. Attention goes through
``ops.attention.attention`` (kernel A on the card); the dense layers are
``torch.matmul``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import DiTConfig
from ..nn.core import dense, embed, layer_norm
from ..ops.attention import attention
from ..ops.rope import apply_rope, rope_tables


def global_adaln(params, x, time_emb, text_emb):
    """x: [B, S, H], time_emb: [B, Td], text_emb: [B, St, Xd]."""
    text_pooled = text_emb.mean(dim=1)
    tmod = dense(params["time_mlp"], F.silu(time_emb))
    xmod = dense(params["text_mlp"], F.silu(text_pooled))
    t_scale, t_shift = tmod.chunk(2, dim=-1)
    x_scale, x_shift = xmod.chunk(2, dim=-1)
    scale = 1.0 + t_scale + x_scale
    shift = t_shift + x_shift
    x = layer_norm({}, x)
    return x * scale[:, None, :] + shift[:, None, :]


def _split_heads(x, num_heads: int):
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, nh, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * d)


def prepare_blocks(params, cfg: DiTConfig) -> List[Dict]:
    """The block parameters cast to ``cfg.compute_dtype``, once per
    request (not per denoising step)."""
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(cdt)

    return [cast(b) for b in params["blocks"]]


def prepare_cross_kv(blocks, cfg: DiTConfig, text_emb):
    """Every layer's cross-attention (K, V), each [B, nh, St, hd], from the
    text embedding, which is constant across the denoising loop."""
    h = cfg.hidden_dim
    out = []
    for blk in blocks:
        w = blk["cross_attn"]["in_proj_weight"]
        b = blk["cross_attn"]["in_proj_bias"]
        te = text_emb.to(w.dtype)
        k = dense({"weight": w[h:2 * h], "bias": b[h:2 * h]}, te)
        v = dense({"weight": w[2 * h:], "bias": b[2 * h:]}, te)
        out.append((_split_heads(k, cfg.num_heads),
                    _split_heads(v, cfg.num_heads)))
    return out


def prepare(params, cfg: DiTConfig, text_emb, seq_len: int):
    """Per-request state for ``ditto_forward``: cast blocks, cross K/V and
    the RoPE tables."""
    blocks = prepare_blocks(params, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    return {"blocks": blocks,
            "cross_kv": prepare_cross_kv(blocks, cfg, text_emb),
            "rope": rope_tables(seq_len, cfg.head_dim, dtype=cdt,
                                device=text_emb.device)}


def dit_block(params, cfg: DiTConfig, x, rope_cs: Tuple, cross_kv: Tuple):
    """One DiT block. rope_cs = (cos, sin); cross_kv = this layer's (K, V)."""
    nh = cfg.num_heads

    # self-attention with RoPE
    residual = x
    xn = layer_norm(params["norm1"], x)
    attn_p = params["attn"]
    qkv = dense({"weight": attn_p["in_proj_weight"],
                 "bias": attn_p["in_proj_bias"]}, xn)
    q, k, v = qkv.chunk(3, dim=-1)
    b, s, h = q.shape
    cos, sin = rope_cs
    q = apply_rope(q.reshape(b, s, nh, h // nh), cos, sin).transpose(1, 2)
    k = apply_rope(k.reshape(b, s, nh, h // nh), cos, sin).transpose(1, 2)
    v = _split_heads(v, nh)
    attn_out = _merge_heads(attention(q, k, v))
    if not cfg.ref_compat:
        attn_out = dense(attn_p["out_proj"], attn_out)
    x = attn_out + residual  # quirk #2: the reference skips out_proj

    # cross-attention to the text (K/V precomputed per request)
    residual = x
    xn = layer_norm(params["norm2"], x)
    w = params["cross_attn"]["in_proj_weight"]
    bb = params["cross_attn"]["in_proj_bias"]
    q = _split_heads(dense({"weight": w[:h], "bias": bb[:h]}, xn), nh)
    k, v = cross_kv
    cross = dense(params["cross_attn"]["out_proj"],
                  _merge_heads(attention(q, k, v)))
    x = cross + residual

    # gated MLP
    residual = x
    xn = layer_norm(params["norm3"], x)
    up = F.gelu(dense(params["mlp_fc1"], xn))
    gate = torch.sigmoid(dense(params["gate"], xn))
    return dense(params["mlp_fc2"], up * gate) + residual


def ditto_forward(params, cfg: DiTConfig, x, text_emb, t, *,
                  prepared: Optional[Dict] = None):
    """Noise prediction. x: [B, S, H] noisy latents; text_emb: [B, St, Xd];
    t: [B] int. ``prepared`` is ``prepare(...)`` for this request."""
    if prepared is None:
        prepared = prepare(params, cfg, text_emb, x.shape[1])
    temb = embed(params["t_embedding"], t)
    temb = dense(params["time_embed"]["fc1"], temb)
    temb = F.silu(temb)
    temb = dense(params["time_embed"]["fc2"], temb)

    x_skip = dense(params["proj_in"], x)
    x = global_adaln(params["ada_ln"], x, temb, text_emb)

    # mixed precision: compute-dtype operands inside the block stack, fp32
    # statistics in layer_norm and softmax
    cdt = getattr(torch, cfg.compute_dtype)
    x = x.to(cdt)
    for blk, ckv in zip(prepared["blocks"], prepared["cross_kv"]):
        x = dit_block(blk, cfg, x, prepared["rope"], ckv)

    x = dense(params["proj_out"], x.to(x_skip.dtype))
    return x_skip + x
