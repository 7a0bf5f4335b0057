"""VALL-E's AR and NAR decoders (arXiv:2301.02111 §5.1; the layer
equations of lifeiteng/vall-e ``valle/models/valle.py``) in plain fp32
PyTorch, for the CPU tests: no kernels, no cache, no batching tricks, and
nothing of the port imported. The benchmark's copy
(``benchmark/reference/valle.py``) adds a precision to every product.

  PE     pe[p, 2j] = sin(p w_j), pe[p, 2j+1] = cos(p w_j), w_j =
         10000^(-2j/d); a stream's embedding is E[id] + alpha PE(0..), text
         and audio each with its own table, alpha and positions from 0.
  layer  h = h + Wo softmax_masked(q k^T / sqrt(hd)) v + bo, with q, k, v
         = split(Wi LN1(h) + bi) into heads; h = h + W2 ReLU(W1 LN2(h) +
         b1) + b2; a final LN. LN: (x - mean) / sqrt(var + eps), the
         biased variance, then w x + b.
  AR     [text T; audio] with audio = E_a[c_1]; text row r sees keys < T;
         audio row T + i sees keys < T and audio keys 0..i; logits = W_out
         LN(h_audio) (codebook_size + 1 ids, EOS the last), teacher-forced:
         the row of audio position i gives the logits of the token at i + 1.
  NAR    stage k = 2..8 over [text; prompt P; target N], unmasked, with the
         prompt's audio sum_{j<=8} E_j[c_j], the target's sum_{j<k}
         E_j[c_j], alpha PE over the P + N audio frames; each LN (the final
         too) adaptive: (w, b) = split(W e_k + b_W), y = w LN(h) + b with a
         non-affine LN; logits W_k h over the target's frames.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


QUERY_BLOCK = 256


def linear(p, x):
    y = torch.matmul(x, p["weight"].float().t())
    return y + p["bias"].float() if p.get("bias") is not None else y


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


def adaptive(p, e):
    """The AdaLN of stage vector e: x -> w LN(x) + b."""
    w, b = linear(p, e[None])[0].chunk(2)
    return lambda x: w * ln(x) + b


def attention(q, k, v, visible):
    """softmax(q k^T / sqrt(d), masked where ``visible(rows, keys)`` is
    false) v over [B, H, S, D], in blocks of query rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    keys = torch.arange(k.shape[2], device=q.device)
    out = []
    for s in range(0, q.shape[2], QUERY_BLOCK):
        rows = torch.arange(s, min(s + QUERY_BLOCK, q.shape[2]),
                            device=q.device)
        sc = torch.matmul(q[:, :, s:s + QUERY_BLOCK],
                          k.transpose(-1, -2)) * scale
        if visible is not None:
            sc = sc.masked_fill(~visible(rows[:, None], keys[None]),
                                float("-inf"))
        out.append(torch.matmul(torch.softmax(sc, dim=-1), v))
    return torch.cat(out, dim=2)


def stack(layers, x, heads: int, norms, visible):
    """The pre-LN layers over x [B, S, D]; ``norms(layer)`` gives the
    layer's (norm1, norm2)."""
    b, s, d = x.shape
    for p in layers:
        n1, n2 = norms(p)
        qkv = linear(p["attn"]["in_proj"], n1(x))
        q, k, v = qkv.view(b, s, 3, heads, d // heads).permute(
            2, 0, 3, 1, 4)
        a = attention(q, k, v, visible)
        a = a.transpose(1, 2).reshape(b, s, d)
        x = x + linear(p["attn"]["out_proj"], a)
        f = F.relu(linear(p["ff1"], n2(x)))
        x = x + linear(p["ff2"], f)
    return x


def _embed(table, alpha, ids, pe):
    return table["weight"].float()[ids] + alpha.float() * pe[:ids.shape[1]]


def ar_logits(p, model: dict, text, audio):
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
              lambda r, k: (k < t) | (k <= r))
    h = ln(x[:, t:], p["norm"], eps)
    return torch.matmul(h, p["head"]["weight"].float().t())


def decoded_logits(p, model: dict, text, prompt_c1, tokens):
    """The logits [B, N, 1025] that the AR gives each of the N decoded
    tokens, teacher-forced on the prompt's first codebook [B, P] and the
    tokens [B, N]."""
    audio = torch.cat([prompt_c1, tokens[:, :-1]], dim=1)
    return ar_logits(p, model, text, audio)[:, prompt_c1.shape[1] - 1:]


def nar_logits(p, model: dict, stage: int, text, prompt_codes, codes):
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

    def norms(lp):
        return adaptive(lp["norm1"], e), adaptive(lp["norm2"], e)

    x = stack(p["layers"], x, model["nhead"], norms, None)
    h = adaptive(p["norm"], e)(x[:, t + pn:])
    return torch.matmul(h, p["heads"][stage - 2]["weight"].float().t())
