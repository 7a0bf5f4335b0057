"""F5-TTS v1 (SWivid/F5-TTS ``model/backbones/dit.py``, ``modules.py``,
``cfm.py``; arXiv:2410.06885) in plain PyTorch, from its equations, with
the precision of every product given (``precision.py``): the DiT, its
guided velocity and the sway-sampled Euler sampler.

  text   Embedding(ids + 1), 0 the filler padding to N frames, + the
         table cat(cos, sin)(pos 10000^(-2j/td)); padded frames zeroed;
         ConvNeXt-V2 blocks (depthwise conv k7 pad 3, LayerNorm eps 1e-6,
         Linear, exact GELU, GRN = g (x Nx) + b + x with Nx = |x|_2 over
         time / (its mean over channels + 1e-6), Linear, + residual), the
         padded frames zeroed after each. Dropped text (the unconditional
         rows) is all filler under the real text's padding.
  input  Linear(cat(x, cond, text)); h + Mish(conv(Mish(conv(h)))), each
         conv k31 pad 15 in 16 groups. Dropped audio is cond = 0.
  time   cat(sin, cos)(1000 t exp(-ln(1e4) i / (half - 1))), Linear,
         SiLU, Linear.
  block  shift_a, scale_a, gate_a, shift_f, scale_f, gate_f =
         Linear(SiLU(t)); x += gate_a Attn(LN(x)(1 + scale_a) + shift_a);
         x += gate_f FF(LN(x)(1 + scale_f) + shift_f). Attn: q, k, v
         Linear each, heads of 64, rotary angles pos 10000^(-2j/64)
         repeated pairwise and pairs (a, b) -> (-b, a) on q and k,
         softmax(q k^T / 8) v, Linear. FF: Linear, GELU (tanh), Linear.
  out    scale, shift = Linear(SiLU(t)); Linear(LN(x)(1 + scale) + shift).
  flow   t = linspace(0, 1, K + 1) + s (cos(pi t / 2) - 1 + t); y += dt
         (v_c + w (v_c - v_u)); the prompt's frames then take cond.

Parameters are the tree the benchmark draws (``params.f5_spec``'s
layout: dicts of tensors, torch layouts). ``prec`` gives the precision of
the block stack's products, conv position embedding and output
projection (``blocks``), the type the residual stream is kept in
(``carry``), and of the rest (``other``). Departures from F5's code: the
attention is computed in blocks of queries (the same sums, in less
memory); the unconditional rows' text embedding is computed once, not
every step (it does not depend on t).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import conv1d, linear, matmul, rnd

QUERY_BLOCK = 512


def ln(x, p=None, eps: float = 1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if p:
        y = y * p["weight"].float() + p["bias"].float()
    return y


def _conv_nlc(p, x, prec, groups):
    k = p["weight"].shape[-1]
    return conv1d(x.transpose(1, 2), p["weight"], p["bias"], prec=prec,
                  padding=k // 2, groups=groups).transpose(1, 2)


def grn(p, h):
    """ConvNeXt-V2's GRN over [B, N, C]."""
    nx = torch.sqrt(h.square().sum(dim=1, keepdim=True))
    nx = nx / (nx.mean(dim=-1, keepdim=True) + 1e-6)
    return p["gamma"].float() * (h * nx) + p["beta"].float() + h


def conv_position(p, h, groups: int, prec):
    """Mish(conv2(Mish(conv1(h)))) over [R, N, C]."""
    c = F.mish(_conv_nlc(p["conv1"], h, prec, groups))
    return F.mish(_conv_nlc(p["conv2"], c, prec, groups))


def text_rows(p, dit: dict, ids, n: int, prec):
    """(conditional, unconditional) text embeddings, each [B, N, td]."""
    b, td = ids.shape[0], dit["text_dim"]
    tok = torch.zeros((b, n), dtype=torch.long, device=ids.device)
    m = min(n, ids.shape[1])
    tok[:, :m] = ids[:, :m].long() + 1
    pad = (tok == 0)[..., None]
    j = torch.arange(0, td, 2, device=ids.device)[:td // 2].float()
    freqs = 1.0 / 10000.0 ** (j / td)
    pos = torch.arange(n, device=ids.device).clamp(
        max=dit["text_max_pos"] - 1).float()
    ang = pos[:, None] * freqs[None]
    table = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    out = []
    for t in (tok, torch.zeros_like(tok)):
        x = p["text_embed"]["embed"]["weight"].float()[t] + table
        x = torch.where(pad, torch.zeros_like(x), x)
        for blk in p["text_embed"]["blocks"]:
            h = _conv_nlc(blk["dwconv"], x, prec, td)
            h = ln(h, blk["norm"])
            h = F.gelu(linear(blk["pwconv1"], h, prec))
            h = grn(blk["grn"], h)
            x = x + linear(blk["pwconv2"], h, prec)
            x = torch.where(pad, torch.zeros_like(x), x)
        out.append(x)
    return out[0], out[1]


def time_embedding(p, dit: dict, t, prec):
    half = dit["time_freq_dim"] // 2
    k = math.log(10000.0) / (half - 1)
    f = torch.exp(-k * torch.arange(half, device=t.device).float())
    a = 1000.0 * t.float()[:, None] * f[None]
    e = torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    h = F.silu(linear(p["time_embed"]["fc1"], e, prec))
    return linear(p["time_embed"]["fc2"], h, prec)


def rotary(n: int, d: int, device):
    j = torch.arange(0, d, 2, device=device).float()
    inv = 1.0 / 10000.0 ** (j / d)
    ang = torch.arange(n, device=device).float()[:, None] * inv[None]
    ang = torch.stack([ang, ang], dim=-1).reshape(n, d)
    return torch.cos(ang), torch.sin(ang)


def _rotate_pairs(x, cos, sin):
    a, b = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-b, a], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def attention(q, k, v, prec):
    """softmax(q k^T / sqrt(d)) v over [R, H, N, D], in blocks of
    queries."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = []
    for s in range(0, q.shape[2], QUERY_BLOCK):
        sc = matmul(q[:, :, s:s + QUERY_BLOCK], k.transpose(-1, -2),
                    prec) * scale
        out.append(matmul(torch.softmax(sc, dim=-1), v, prec))
    return torch.cat(out, dim=2)


def dit_forward(p, dit: dict, x, cond, text, t, prec):
    """The velocity [R, N, mel] of rows x, cond [R, N, mel], text [R, N,
    td], t [R]."""
    pb, pc, po = prec["blocks"], prec.get("carry", "float32"), prec["other"]
    r, n, _ = x.shape
    d, nh = dit["dim"], dit["heads"]
    hd = dit["dim_head"]
    st = F.silu(time_embedding(p, dit, t, po))
    h = linear(p["input_embed"]["proj"], torch.cat([x, cond, text], -1), po)
    h = rnd(h, pc)
    g = dit["conv_pos_groups"]
    h = rnd(h + conv_position(p["input_embed"], h, g, pb), pc)
    cos, sin = rotary(n, hd, x.device)
    for blk in p["blocks"]:
        mod = linear(blk["attn_norm"], st, po)
        sa, ca, ga, sf, cf, gf = [m[:, None] for m in mod.chunk(6, dim=-1)]
        y = ln(h) * (1 + ca) + sa

        def heads(name):
            return linear(blk[name], y, pb).reshape(r, n, nh, hd)

        q = _rotate_pairs(heads("to_q"), cos[:, None], sin[:, None])
        k = _rotate_pairs(heads("to_k"), cos[:, None], sin[:, None])
        v = heads("to_v")
        a = attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), pb)
        a = linear(blk["to_out"], a.transpose(1, 2).reshape(r, n, d), pb)
        h = rnd(h + ga * rnd(a, pc), pc)
        y = ln(h) * (1 + cf) + sf
        f = linear(blk["ff2"], F.gelu(linear(blk["ff1"], y, pb),
                                      approximate="tanh"), pb)
        h = rnd(h + gf * rnd(f, pc), pc)
    scale, shift = linear(p["norm_out"], st, po).chunk(2, dim=-1)
    y = ln(h) * (1 + scale[:, None]) + shift[:, None]
    return linear(p["proj_out"], y, pb)


def guided(p, dit: dict, y, cond, text_c, text_u, t, strength: float,
           prec):
    """v_c + strength (v_c - v_u) from one forward over both row sets."""
    out = dit_forward(p, dit, torch.cat([y, y]),
                      torch.cat([cond, torch.zeros_like(cond)]),
                      torch.cat([text_c, text_u]), torch.cat([t, t]), prec)
    v_c, v_u = out.chunk(2)
    return v_c + strength * (v_c - v_u)


def times(sampler: dict) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, sampler["steps"] + 1, dtype=torch.float32)
    s = sampler["sway_coef"]
    return t + s * (torch.cos(math.pi / 2 * t) - 1.0 + t)


def flow(p, dit: dict, sampler: dict, cond_mel, ids, y0, prec,
         record_at=None):
    """The sampled mel [B, N, mel] from y0 [B, N, mel] and the prompt's
    mel cond_mel [B, P, mel]; with ``record_at`` = i, also the state
    before step i."""
    b, n, m = y0.shape
    cond = torch.zeros_like(y0)
    cond[:, :cond_mel.shape[1]] = cond_mel.float()
    text_c, text_u = text_rows(p["dit"], dit, ids, n, prec["other"])
    ts = times(sampler)
    y, seen = y0.float(), None
    for i in range(sampler["steps"]):
        if i == record_at:
            seen = y.clone()
        t = ts[i].to(y.device).expand(b)
        y = y + (ts[i + 1] - ts[i]).to(y.device) * guided(
            p["dit"], dit, y, cond, text_c, text_u, t,
            sampler["cfg_strength"], prec)
    y = torch.cat([cond[:, :cond_mel.shape[1]], y[:, cond_mel.shape[1]:]],
                  dim=1)
    return (y, seen) if record_at is not None else y


def velocity(p, dit: dict, sampler: dict, cond_mel, ids, y, t: float, prec):
    """One guided velocity at state y and time t."""
    b, n, _ = y.shape
    cond = torch.zeros_like(y)
    cond[:, :cond_mel.shape[1]] = cond_mel.float()
    text_c, text_u = text_rows(p["dit"], dit, ids, n, prec["other"])
    tt = torch.full((b,), t, dtype=torch.float32, device=y.device)
    return guided(p["dit"], dit, y.float(), cond, text_c, text_u, tt,
                  sampler["cfg_strength"], prec)


def prompt_gain(audio, target: float):
    """(RMS [B], the gain lifting a quieter prompt to ``target``)."""
    rms = torch.sqrt(audio.float().square().mean(dim=(1, 2)))
    return rms, torch.where(rms < target, target / rms, torch.ones_like(rms))
