"""VALL-E (arXiv:2301.02111 §5.1; the layer equations of lifeiteng/vall-e
``valle/models/valle.py``) in plain PyTorch, from its equations, with the
precision of every product given (``precision.py``), and the comparison
that decides the VALL-E cell's ``correct``.

  PE     pe[p, 2j] = sin(p w_j), pe[p, 2j+1] = cos(p w_j), w_j =
         10000^(-2j/d); a stream's embedding is E[id] + alpha PE(0..), text
         and audio each with its own table, alpha and positions from 0.
  layer  h = h + Wo softmax_masked(q k^T / sqrt(64)) v + bo, with q, k, v
         = split(Wi LN1(h) + bi) into 16 heads of 64; h = h + W2 ReLU(W1
         LN2(h) + b1) + b2; a final LN. LN: (x - mean) / sqrt(var +
         1e-5), the biased variance, then w x + b.
  AR     [text T; audio] with audio = E_a[c_1]; text row r sees keys < T;
         audio row T + i sees keys < T and audio keys 0..i; logits = W_out
         LN(h_audio) (1025 ids, EOS the last). Teacher-forced here on the
         prompt's first codebook and the program's drawn tokens: the row of
         audio position i gives the logits of the token at i + 1.
  NAR    stage k = 2..8 over [text; prompt P; target N], unmasked, with the
         prompt's audio E_1[c_1] + ... + E_8[c_8], the target's E_1[c_1] +
         ... + E_{k-1}[c_{k-1}], alpha PE over the P + N audio frames; each
         LN (the final too) adaptive: (w, b) = split(W e_k + b_W), y = w
         LN(h) + b with a non-affine LN; logits W_k h over the target's
         frames (1024 codes).

Parameters are the tree the benchmark draws (``params.valle_spec``'s
layout). ``prec`` gives the precision of the 24 layers' products and
attention (``blocks``), of the type the residual stream is kept in
(``carry``), and of the rest (``other``: the heads and the AdaLN
projections). Departures from lifeiteng's code: the attention is computed
in blocks of query rows (the same sums, in less memory); dropout is off
(inference); the NAR's prompt takes all 8 codebooks, as the paper's
Figure 3 does; the AR is not run on the text rows' logits, which no loss
or draw reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import linear, matmul, rnd

QUERY_BLOCK = 256


def sine_pe(n: int, d: int, device):
    w = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / d))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * w
    pe = torch.zeros((n, d), device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def ln(x, p=None, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if p is not None:
        y = y * p["weight"].float() + p["bias"].float()
    return y


def adaptive(p, e, prec):
    """The AdaLN of stage vector e: x -> w LN(x) + b."""
    w, b = linear(p, e[None], prec)[0].chunk(2)
    return lambda x: w * ln(x) + b


def attention(q, k, v, visible, prec):
    """softmax(q k^T / sqrt(d), masked where ``visible(rows, keys)`` is
    false) v over [B, H, S, D], in blocks of query rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    keys = torch.arange(k.shape[2], device=q.device)
    out = []
    for s in range(0, q.shape[2], QUERY_BLOCK):
        rows = torch.arange(s, min(s + QUERY_BLOCK, q.shape[2]),
                            device=q.device)
        sc = matmul(q[:, :, s:s + QUERY_BLOCK], k.transpose(-1, -2),
                    prec) * scale
        if visible is not None:
            sc = sc.masked_fill(~visible(rows[:, None], keys[None]),
                                float("-inf"))
        out.append(matmul(torch.softmax(sc, dim=-1), v, prec))
    return torch.cat(out, dim=2)


def stack(layers, x, heads: int, norms, visible, prec):
    """The pre-LN layers over x [B, S, D] fp32; ``norms(layer)`` gives the
    layer's (norm1, norm2)."""
    b, s, d = x.shape
    blocks, carry = prec["blocks"], prec["carry"]
    x = rnd(x, carry)
    for p in layers:
        n1, n2 = norms(p)
        qkv = linear(p["attn"]["in_proj"], n1(x), blocks)
        q, k, v = qkv.view(b, s, 3, heads, d // heads).permute(
            2, 0, 3, 1, 4)
        a = attention(q, k, v, visible, blocks)
        a = a.transpose(1, 2).reshape(b, s, d)
        x = rnd(x + linear(p["attn"]["out_proj"], a, blocks), carry)
        f = F.relu(linear(p["ff1"], n2(x), blocks))
        x = rnd(x + linear(p["ff2"], f, blocks), carry)
    return x


def _embed(table, alpha, ids, pe):
    return table["weight"].float()[ids] + alpha.float() * pe[:ids.shape[1]]


def ar_logits(p, model: dict, text, audio, prec):
    """Logits [B, S_a, 1025] of the AR at each audio position, over
    [text [B, T]; audio [B, S_a]] (ids with EOS)."""
    t, d = text.shape[1], model["d_model"]
    pe = sine_pe(max(t, audio.shape[1]), d, text.device)
    x = torch.cat([_embed(p["text_embed"], p["text_alpha"], text, pe),
                   _embed(p["audio_embed"], p["audio_alpha"], audio, pe)],
                  dim=1)
    eps = model["norm_eps"]

    def norms(lp):
        return (lambda h: ln(h, lp["norm1"], eps),
                lambda h: ln(h, lp["norm2"], eps))

    x = stack(p["layers"], x, model["nhead"], norms,
              lambda r, k: (k < t) | (k <= r), prec)
    h = ln(x[:, t:], p["norm"], eps)
    return matmul(h, p["head"]["weight"].float().t(), prec["other"])


def decoded_logits(p, model: dict, text, prompt_c1, tokens, prec):
    """The logits [B, N, 1025] that the AR gives each of the N decoded
    tokens, teacher-forced on the prompt's first codebook [B, P] and the
    tokens [B, N]."""
    audio = torch.cat([prompt_c1, tokens[:, :-1]], dim=1)
    return ar_logits(p, model, text, audio, prec)[:, prompt_c1.shape[1] - 1:]


def nar_logits(p, model: dict, stage: int, text, prompt_codes, codes, prec):
    """Logits [B, N, 1024] of NAR stage ``stage`` over the target frames,
    from the prompt's codes [B, 8, P] and the target's codes [B, 8, N] (the
    first stage - 1 codebooks read)."""
    t, d = text.shape[1], model["d_model"]
    pn, n = prompt_codes.shape[2], codes.shape[2]
    pe = sine_pe(max(t, pn + n), d, text.device)
    tables = p["audio_embeds"]
    prompt = sum(tables[j]["weight"].float()[prompt_codes[:, j]]
                 for j in range(model["num_codebooks"]))
    target = sum(tables[j]["weight"].float()[codes[:, j]]
                 for j in range(stage - 1))
    audio = torch.cat([prompt, target], dim=1) \
        + p["audio_alpha"].float() * pe[:pn + n]
    x = torch.cat([_embed(p["text_embed"], p["text_alpha"], text, pe), audio],
                  dim=1)
    e = p["stage_embed"]["weight"][stage - 2].float()
    other = prec["other"]

    def norms(lp):
        return adaptive(lp["norm1"], e, other), adaptive(lp["norm2"], e, other)

    x = stack(p["layers"], x, model["nhead"], norms, None, prec)
    h = adaptive(p["norm"], e, other)(x[:, t + pn:])
    return matmul(h, p["heads"][stage - 2]["weight"].float().t(), other)
