"""The DiT and its DDPM sampler in plain fp32 PyTorch (the architecture of
``pipeline.dit``; DiTTo-TTS, arXiv:2406.11427, as the reference
implementation Tikai7/DiTTO-TTS builds it).

  t -> embedding -> Linear, SiLU, Linear                       (time)
  x -> proj_in                                                 (long skip)
  x -> LayerNorm (no affine) * (1 + time_scale + text_scale) + shifts,
       the text mean-pooled                                    (global AdaLN)
  N blocks: self-attention with rotary positions (half-split), cross-
       attention to the text, MLP GELU(fc1) * sigmoid(gate) -> fc2, each
       pre-norm with a residual; ``ref_compat`` drops the self-attention's
       output projection (the reference's quirk)
  proj_out + skip -> the predicted noise

Parameters are the weight tree the benchmark draws (dicts of tensors,
torch layouts). ``prec`` holds the precision of the block stack's
products (``blocks``), of the type its activations are kept in between
them (``carry``: every product's output, attention's, the MLP's gate and
the residual stream rounded to it), and of the rest (``other``).
Cross-attention dropout, where asked for, multiplies the projected
cross-attention output by a keep mask scaled by 1 / (1 - rate).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import linear, matmul, rnd


def layer_norm(x, p=None, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if p:
        y = y * p["weight"].float() + p["bias"].float()
    return y


def rope(seq: int, dim: int, device):
    inv = 1.0 / 10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    ang = np.outer(np.arange(seq, dtype=np.float64), inv)
    ang = np.concatenate([ang, ang], axis=-1)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attend(q, k, v, prec: str):
    """softmax(q k^T / sqrt(d)) v over [B, H, S, D], fp32 softmax."""
    s = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    return matmul(torch.softmax(s, dim=-1), v, prec)


def _heads(x, nh):
    b, s, h = x.shape
    return x.reshape(b, s, nh, h // nh).transpose(1, 2)


def _merge(x):
    b, nh, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * d)


def block(p, dit: dict, x, text_emb, cs, prec, keep=None):
    h, nh = dit["hidden_dim"], dit["num_heads"]
    pb = prec["blocks"]
    pc = prec.get("carry", "float32")

    def c(t):
        return rnd(t, pc)

    def lin(q, t):
        return c(linear(q, t, pb))

    cos, sin = cs
    xn = c(layer_norm(x, p["norm1"]))
    w, b = p["attn"]["in_proj_weight"], p["attn"]["in_proj_bias"]
    q, k, v = (lin({"weight": w[i * h:(i + 1) * h],
                    "bias": b[i * h:(i + 1) * h]}, xn) for i in range(3))
    q, k, v = _heads(q, nh), _heads(k, nh), _heads(v, nh)
    a = c(_merge(attend(c(_rotate(q, cos, sin)), c(_rotate(k, cos, sin)), v,
                        pb)))
    if not dit["ref_compat"]:
        a = lin(p["attn"]["out_proj"], a)
    x = c(x + a)

    xn = c(layer_norm(x, p["norm2"]))
    w, b = p["cross_attn"]["in_proj_weight"], p["cross_attn"]["in_proj_bias"]
    q = lin({"weight": w[:h], "bias": b[:h]}, xn)
    k = lin({"weight": w[h:2 * h], "bias": b[h:2 * h]}, text_emb)
    v = lin({"weight": w[2 * h:], "bias": b[2 * h:]}, text_emb)
    a = lin(p["cross_attn"]["out_proj"],
            c(_merge(attend(_heads(q, nh), _heads(k, nh), _heads(v, nh),
                            pb))))
    if keep is not None:
        a = torch.where(keep, a / (1.0 - dit["cross_attn_dropout"]),
                        torch.zeros((), device=a.device))
    x = c(x + a)

    xn = c(layer_norm(x, p["norm3"]))
    up = c(F.gelu(lin(p["mlp_fc1"], xn)))
    gate = c(torch.sigmoid(lin(p["gate"], xn)))
    return c(x + lin(p["mlp_fc2"], c(up * gate)))


def forward(p, dit: dict, x, text_emb, t, prec, keeps=None):
    """Predicted noise [B, S, H] of latents x [B, S, H] (fp32) at
    timesteps t [B], conditioned on text_emb [B, St, H]."""
    po = prec["other"]
    temb = p["t_embedding"]["weight"][t].float()
    temb = linear(p["time_embed"]["fc2"],
                  F.silu(linear(p["time_embed"]["fc1"], temb, po)), po)
    skip = linear(p["proj_in"], x, po)
    tm = linear(p["ada_ln"]["time_mlp"], F.silu(temb), po)
    xm = linear(p["ada_ln"]["text_mlp"], F.silu(text_emb.mean(dim=1)), po)
    ts, tsh = tm.chunk(2, dim=-1)
    xs, xsh = xm.chunk(2, dim=-1)
    h = layer_norm(x) * (1.0 + ts + xs)[:, None] + (tsh + xsh)[:, None]
    cs = rope(x.shape[1], dit["hidden_dim"] // dit["num_heads"], x.device)
    h = rnd(h, prec.get("carry", "float32"))
    for i, bp in enumerate(p["blocks"]):
        h = block(bp, dit, h, text_emb, cs, prec,
                  None if keeps is None else keeps[i])
    return linear(p["proj_out"], h, po) + skip


def cosine_schedule(steps: int, s: float = 0.008):
    """(betas, alphas_cumprod) fp32 of the clipped cosine schedule."""
    x = np.linspace(0, steps, steps + 1, dtype=np.float64)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0001, 0.9999).astype(np.float32)
    betas = torch.from_numpy(betas)
    return betas, torch.cumprod(1.0 - betas, dim=0)


def respaced(steps: int, k: int):
    taus = np.unique(np.round(np.linspace(0, steps - 1, k)).astype(np.int64))
    return taus[::-1].copy()


def ddpm(p, dit: dict, text_emb, x, draws, num_steps: int, prec):
    """DDPM over the respaced schedule from x; ``draws()`` gives each
    step's noise."""
    _, ac = cosine_schedule(dit["diffusion_steps"])
    taus = respaced(dit["diffusion_steps"], num_steps)
    abar = ac[torch.from_numpy(taus)]
    abar_prev = torch.cat([abar[1:], torch.ones(1)])
    beta = 1.0 - abar / abar_prev
    alpha = 1.0 - beta
    b = x.shape[0]
    for i, t in enumerate(taus):
        tv = torch.full((b,), int(t), dtype=torch.int64, device=x.device)
        eps = forward(p, dit, x, text_emb, tv, prec)
        mean = (x - (1.0 - alpha[i]) / torch.sqrt(1.0 - abar[i]) * eps) \
            / torch.sqrt(alpha[i])
        z = draws()
        x = mean + (1.0 if t > 0 else 0.0) * torch.sqrt(beta[i]) * z
    return x
