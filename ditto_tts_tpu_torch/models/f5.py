"""F5-TTS v1's DiT (SWivid/F5-TTS ``model/backbones/dit.py`` and
``model/modules.py``; arXiv:2410.06885), the velocity model of a
flow-matching sampler over joint mel-and-text frames.

  text:  Embedding(ids + 1) (0 is the filler, padding to the mel length
         N) + the table cat(cos, sin)(pos 10000^(-2j/td)); padded positions
         zeroed, then 4 ConvNeXt-V2 blocks (depthwise conv k7, LayerNorm
         eps 1e-6, Linear, exact GELU, GRN over time, Linear, residual),
         each followed by the zeroing again. The unconditional rows embed
         all-filler ids under the real text's padding.
  input: Linear(cat(x, cond, text)) then h + Mish(conv(Mish(conv(h)))),
         two grouped convs of k31; the unconditional rows take cond = 0.
  time:  cat(sin, cos) of 1000 t at exp(-ln 1e4 i / 127), Linear, SiLU,
         Linear.
  block: (shift, scale, gate) x 2 = Linear(SiLU(t)); h = LN(x)(1 + scale)
         + shift (non-affine, eps 1e-6); x += gate_a Attn(h), q, k and v
         each a biased projection, interleaved RoPE on every head of q and
         k, unmasked softmax attention (kernel A on the card), a biased
         output projection; x += gate_f FF(h'), Linear, tanh-GELU, Linear.
  out:   (scale, shift) = Linear(SiLU(t)); LN(x)(1 + scale) + shift;
         Linear to the mel bins.

``velocity`` is one guided forward: the conditional and unconditional
rows as one batch of 2B and ``v_c + s (v_c - v_u)``. Per-request work is
hoisted into ``prepare``: the text embedding's and cond's columns of the
input projection with its bias (the x columns are applied every step),
the blocks' q, k and v packed into one cast product, every block's
modulation weights stacked into one fp32 product, the casts to the
compute dtype and the RoPE tables.

Precision: the text embedding, the time embedding, the modulations'
weights and the input projection in fp32; the conv position embedding,
the block stack and the output projection with ``compute_dtype``
operands (fp32 sums), the residual stream, the modulated LayerNorm and
the gated residual adds in that type; LayerNorm statistics in fp32; the
velocity returned in fp32. The block's dense layers are ``F.linear``
(the bias in the GEMM's epilogue), the rest ``nn.core.dense``; the
convolutions are ``F.conv1d`` (cuDNN: the JAX package has no F5 and so
no Pallas kernel to port).
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..config import F5DiTConfig
from ..nn.core import dense, layer_norm
from ..ops.attention import attention
from ..ops.rope import apply_rope_interleaved, rope_tables_interleaved


@functools.lru_cache(maxsize=8)
def _text_positions(seq_len: int, dim: int, max_pos: int) -> torch.Tensor:
    """F5's ``precompute_freqs_cis`` rows at positions clamped to
    ``max_pos - 1``: [seq_len, dim] fp32 on the CPU."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2)[:dim // 2].float()
                               / dim))
    ang = torch.outer(torch.arange(max_pos).float(), freqs)
    table = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return table[torch.arange(seq_len).clamp(max=max_pos - 1)]


def _conv(p, x, groups: int):
    """A same-padded Conv1d over [B, N, C] (odd kernel), in x's type."""
    k = p["weight"].shape[-1]
    y = F.conv1d(x.transpose(1, 2), p["weight"].to(x.dtype),
                 p["bias"].to(x.dtype), padding=k // 2, groups=groups)
    return y.transpose(1, 2)


def grn(p, x):
    """ConvNeXt-V2's global response norm over [B, N, C]: the L2 norm over
    time, over its mean over channels (+1e-6)."""
    gx = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return p["gamma"] * (x * nx) + p["beta"] + x


def convnext_block(p, x):
    h = _conv(p["dwconv"], x, groups=x.shape[-1])
    h = layer_norm(p["norm"], h, eps=1e-6)
    h = F.gelu(dense(p["pwconv1"], h))
    return x + dense(p["pwconv2"], grn(p["grn"], h))


def text_embed(params, cfg: F5DiTConfig, text_ids, seq_len: int):
    """Character ids [B, Nt] (-1 pads) -> [2B, seq_len, text_dim] fp32:
    the conditional rows, then the unconditional (all-filler) rows under
    the same padding."""
    ids = text_ids.long()[:, :seq_len] + 1
    ids = F.pad(ids, (0, seq_len - ids.shape[1]), value=0)
    pad = (ids == 0)[..., None]
    pad = torch.cat([pad, pad])
    x = params["embed"]["weight"].float()[torch.cat([ids,
                                                     torch.zeros_like(ids)])]
    x = x + _text_positions(seq_len, cfg.text_dim,
                            cfg.text_max_pos).to(x.device)
    x = x.masked_fill(pad, 0.0)
    for blk in params["blocks"]:
        x = convnext_block(blk, x).masked_fill(pad, 0.0)
    return x


def time_embed(params, cfg: F5DiTConfig, t):
    """Times [B] -> [B, dim] fp32."""
    half = cfg.time_freq_dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device).float()
                      * -(math.log(10000.0) / (half - 1)))
    ang = 1000.0 * t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return dense(params["fc2"], F.silu(dense(params["fc1"], emb)))


def _cast(p: Dict, dtype) -> Dict:
    return {k: v.to(dtype) for k, v in p.items()}


def prepare(params, cfg: F5DiTConfig, cond, text2) -> Dict:
    """Per-request state of ``velocity``: cond [B, N, mel_dim] (the
    prompt's mel in its frames, 0 after), text2 [2B, N, text_dim]
    (``text_embed``)."""
    cdt = getattr(torch, cfg.compute_dtype)
    m = cfg.mel_dim
    proj = params["input_embed"]["proj"]
    w = proj["weight"].float()
    cond = cond.float()
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    static = torch.matmul(cond2, w[:, m:2 * m].t()) + \
        torch.matmul(text2, w[:, 2 * m:].t()) + proj["bias"].float()
    blocks = []
    for b in params["blocks"]:
        qkv = [b[k] for k in ("to_q", "to_k", "to_v")]
        blocks.append({
            "qkv": {"weight": torch.cat([p["weight"] for p in qkv]).to(cdt),
                    "bias": torch.cat([p["bias"] for p in qkv]).to(cdt)},
            "to_out": _cast(b["to_out"], cdt), "ff1": _cast(b["ff1"], cdt),
            "ff2": _cast(b["ff2"], cdt)})
    return {
        "x_proj": w[:, :m].contiguous(), "static": static,
        "conv1": _cast(params["input_embed"]["conv1"], cdt),
        "conv2": _cast(params["input_embed"]["conv2"], cdt),
        "blocks": blocks,
        "mod": {"weight": torch.cat([b["attn_norm"]["weight"]
                                     for b in params["blocks"]]).float(),
                "bias": torch.cat([b["attn_norm"]["bias"]
                                   for b in params["blocks"]]).float()},
        "proj_out": _cast(params["proj_out"], cdt),
        "rope": rope_tables_interleaved(cond.shape[1], cfg.dim_head,
                                        dtype=cdt, device=cond.device),
    }


def _modulate(x, shift, scale):
    """LN(x)(1 + scale) + shift in x's type (the LayerNorm's statistics in
    fp32); shift, scale [R, D] fp32."""
    y = F.layer_norm(x, x.shape[-1:], eps=1e-6)
    return torch.addcmul(shift[:, None].to(x.dtype), y,
                         (1.0 + scale[:, None]).to(x.dtype))


def _linear(p, x):
    """``x @ W.T + b`` with the bias in the GEMM's epilogue."""
    return F.linear(x, p["weight"], p["bias"])


def block(p, cfg: F5DiTConfig, x, mod, rope_cs):
    """One AdaLN-Zero block over x [R, N, D] (compute dtype); mod [R, 6, D]
    fp32 (shift, scale, gate of the attention, then of the
    feed-forward)."""
    shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mod.unbind(1)
    cdt = x.dtype
    r, n, _ = x.shape
    nh, hd = cfg.heads, cfg.dim_head
    cos, sin = rope_cs
    q, k, v = _linear(p["qkv"], _modulate(x, shift_a, scale_a)).chunk(
        3, dim=-1)
    q = apply_rope_interleaved(q.unflatten(-1, (nh, hd)), cos, sin)
    k = apply_rope_interleaved(k.unflatten(-1, (nh, hd)), cos, sin)
    v = v.unflatten(-1, (nh, hd))
    a = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    a = _linear(p["to_out"], a.transpose(1, 2).reshape(r, n, nh * hd))
    x = torch.addcmul(x, gate_a[:, None].to(cdt), a)
    f = _linear(p["ff2"], F.gelu(_linear(p["ff1"], _modulate(
        x, shift_f, scale_f)), approximate="tanh"))
    return torch.addcmul(x, gate_f[:, None].to(cdt), f)


def velocity(params, cfg: F5DiTConfig, x, t, prep: Dict,
             cfg_strength: float):
    """The guided velocity [B, N, mel_dim] fp32 at the state x [B, N,
    mel_dim] and times t [B]: one forward over the 2B conditional and
    unconditional rows, ``v_c + cfg_strength (v_c - v_u)``."""
    b = x.shape[0]
    cdt = getattr(torch, cfg.compute_dtype)
    st = F.silu(time_embed(params["time_embed"], cfg, t))
    mods = dense(prep["mod"], st).view(b, cfg.depth, 6, cfg.dim)
    mods = torch.cat([mods, mods])
    h = torch.matmul(x.float(), prep["x_proj"].t())
    h = (torch.cat([h, h]) + prep["static"]).to(cdt)
    g = cfg.conv_pos_groups
    h = h + F.mish(_conv(prep["conv2"], F.mish(_conv(prep["conv1"], h, g)),
                         g))
    for i, blk in enumerate(prep["blocks"]):
        h = block(blk, cfg, h, mods[:, i], prep["rope"])
    scale, shift = dense(params["norm_out"], st).chunk(2, dim=-1)
    h = _modulate(h, torch.cat([shift, shift]), torch.cat([scale, scale]))
    out = _linear(prep["proj_out"], h).float()
    v_c, v_u = out.chunk(2)
    return v_c + (v_c - v_u) * cfg_strength
