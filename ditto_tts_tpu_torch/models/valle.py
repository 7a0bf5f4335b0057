"""VALL-E's decoders (arXiv:2301.02111 §5.1; the layer equations of the
open implementation lifeiteng/vall-e ``valle/models/valle.py``): an
autoregressive (AR) codec language model over the first EnCodec codebook
and a non-autoregressive (NAR) model over codebooks 2..8.

  PE     interleaved sin / cos: pe[p, 2j] = sin(p w_j), pe[p, 2j+1] =
         cos(p w_j), w_j = 10000^(-2j/d); each embedded stream (text,
         audio) adds alpha PE(0..), with a learnable scalar alpha of its
         own; audio positions start at 0.
  layer  pre-LN: h += MHA(LN(h), mask), heads of d / nhead with biased
         in- and out-projections; h += W2 ReLU(W1 LN(h) + b1) + b2; a
         final LN after the last layer.
  AR     [text; audio] with E_x[x] + alpha_x PE and E_a[c_1] + alpha_a PE
         (ids up to EOS); a text row sees the text keys, audio row i every
         text key and audio keys 0..i (A's prefix-causal mask); logits
         W_out LN(h) over codebook_size + 1 ids, no bias.
  NAR    stage k = 2..8: [text; prompt; target] with the prompt's frames
         embedded as sum_{j<=8} E_j[c_j], the target's as sum_{j<k}
         E_j[c_j], alpha_a PE over the whole audio sequence; full
         attention; every LN, the final one too, is adaptive: (w, b) =
         split(W e_k + b_W) of the stage embedding e_k, y = w LN(h) + b
         (LN without affine); head W_k (no bias) over the target frames,
         codes by argmax.

``prepare`` casts a decoder's layer weights to the compute dtype once a
request. ``ar_prefill`` runs the AR over [text; audio] writing every
layer's K and V into a ``KVCache`` (``infer/kv_cache.py``);
``ar_decode_step`` embeds one token a row at a device-side position,
appends its K and V, attends over the cache (A's decode launch on the
card, the length read on the device) and returns fp32 logits, so one
captured graph of it serves every position. ``nar_logits`` is one NAR
stage. ``sample_top_k`` draws top-k at a temperature by Gumbel-max from a
counter-based hash of (seed, offset, row, rank), whose state is device
tensors alone.

Precision: the layers' GEMMs and attention take compute-dtype operands
(fp32 sums), and the residual stream is kept in that type; LayerNorm
statistics, the embeddings and PE, the heads' logits, the AdaLN
modulations and the sampling are fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from ..config import ValleModelConfig
from ..ops.attention import attention


def sine_pe(n: int, d: int, device) -> torch.Tensor:
    """The interleaved sinusoid table [n, d] fp32."""
    w = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / d))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * w
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(n, d)


def prepare(params: Dict, cfg: ValleModelConfig) -> List[Dict]:
    """A decoder's layers with the dense weights in the compute dtype (the
    norms' parameters stay as they are)."""
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(p):
        return {"weight": p["weight"].to(cdt), "bias": p["bias"].to(cdt)}

    return [{"in_proj": cast(p["attn"]["in_proj"]),
             "out_proj": cast(p["attn"]["out_proj"]),
             "ff1": cast(p["ff1"]), "ff2": cast(p["ff2"]),
             "norm1": p["norm1"], "norm2": p["norm2"]}
            for p in params["layers"]]


def layer(p: Dict, cfg: ValleModelConfig, x, norm1: Callable,
          norm2: Callable, attend: Callable):
    """One pre-LN layer over x [B, S, D] (compute dtype). ``norm_i(x)``
    gives the normalised input in x's type; ``attend(q, k, v)`` takes
    [B, H, S, hd] views and returns [B, H, S, hd]."""
    b, s, d = x.shape
    qkv = F.linear(norm1(x), p["in_proj"]["weight"], p["in_proj"]["bias"])
    q, k, v = qkv.view(b, s, 3, cfg.nhead, cfg.head_dim).unbind(2)
    a = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    x = x + F.linear(a.transpose(1, 2).reshape(b, s, d),
                     p["out_proj"]["weight"], p["out_proj"]["bias"])
    f = F.relu(F.linear(norm2(x), p["ff1"]["weight"], p["ff1"]["bias"]))
    return x + F.linear(f, p["ff2"]["weight"], p["ff2"]["bias"])


def _ln(p: Dict, eps: float):
    """LayerNorm with affine p, fp32 statistics, out in the input's type."""
    def norm(x):
        return F.layer_norm(x.float(), x.shape[-1:], p["weight"].float(),
                            p["bias"].float(), eps).to(x.dtype)
    return norm


def _ada(p: Dict, e, eps: float):
    """The AdaLN of stage vector e [D]: w LN(x) + b, (w, b) = split(W e +
    b_W), fp32, out in the input's type."""
    w, b = F.linear(e.float(), p["weight"].float(),
                    p["bias"].float()).chunk(2, dim=-1)

    def norm(x):
        y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
        return torch.addcmul(b, y, w).to(x.dtype)
    return norm


def _embed(table: Dict, alpha, ids, pe):
    return table["weight"].float()[ids] + alpha.float() * pe


# ---------------------------------------------------------------------------
# the AR model
# ---------------------------------------------------------------------------

def ar_prefill(params: Dict, layers: List[Dict], cfg: ValleModelConfig,
               text_ids, audio_ids, cache, pe) -> None:
    """The AR over [text [B, T]; audio [B, Pa]] with the prefix-causal
    mask, writing each layer's K and V at cache positions 0..T+Pa-1; ``pe``
    a table of at least max(T, Pa) rows. No logits: the decode step
    draws every token."""
    cdt = getattr(torch, cfg.compute_dtype)
    t, pa = text_ids.shape[1], audio_ids.shape[1]
    x = torch.cat([_embed(params["text_embed"], params["text_alpha"],
                          text_ids, pe[:t]),
                   _embed(params["audio_embed"], params["audio_alpha"],
                          audio_ids, pe[:pa])], dim=1).to(cdt)
    s = t + pa
    for i, p in enumerate(layers):
        def attend(q, k, v, i=i):
            cache.write(i, k, v)
            return attention(q, cache.k[i], cache.v[i], causal=True,
                             prefix=t, kv_len=s)
        x = layer(p, cfg, x, _ln(p["norm1"], cfg.norm_eps),
                  _ln(p["norm2"], cfg.norm_eps), attend)


def ar_decode_step(params: Dict, layers: List[Dict], cfg: ValleModelConfig,
                   tok, apos, text_len: int, cache, pe):
    """Logits [B, codebook_size + 1] fp32 of the AR at one token a row:
    ``tok`` [B] int64 at audio position ``apos`` ([1] int64, on the
    device), whose K and V go to cache position text_len + apos; every
    key up to it is attended (A's decode launch, the length from the
    device)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = (params["audio_embed"]["weight"].float()[tok]
         + params["audio_alpha"].float() * pe.index_select(0, apos)
         ).to(cdt)[:, None]
    cpos = apos + text_len
    kv_lens = (cpos + 1).to(torch.int32)
    for i, p in enumerate(layers):
        def attend(q, k, v, i=i):
            cache.append(i, cpos, k, v)
            return attention(q, cache.k[i], cache.v[i], kv_lens=kv_lens)
        x = layer(p, cfg, x, _ln(p["norm1"], cfg.norm_eps),
                  _ln(p["norm2"], cfg.norm_eps), attend)
    h = F.layer_norm(x[:, 0].float(), (cfg.d_model,),
                     params["norm"]["weight"].float(),
                     params["norm"]["bias"].float(), cfg.norm_eps)
    return torch.matmul(h, params["head"]["weight"].float().t())


# ---------------------------------------------------------------------------
# sampling: a counter-based hash, so the state is device tensors alone
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _pcg(x):
    """The PCG hash of int64 tensors holding 32-bit values (every product
    stays below 2^63)."""
    x = (x * 747796405 + 2891336453) & _M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (x >> 22) ^ x


def uniforms(seed, offset, lanes):
    """Uniforms in (0, 1), fp32, of the hash of ``seed`` ([2] int64, 32-bit
    halves), ``offset`` ([1] int64) and ``lanes`` (int64, the draw's
    index in the step); 24 bits each."""
    h = _pcg(_pcg(_pcg(seed[0:1]) ^ seed[1:2]) ^ (offset & _M32))
    h = _pcg(h ^ lanes)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_top_k(logits, seed, offset, lanes, k: int, temperature: float,
                 bias):
    """One id a row from the top ``k`` of ``logits / temperature`` [B, V]
    (plus ``bias`` [V], -inf where an id may not be drawn), by Gumbel-max
    over the k candidates with ``uniforms(seed, offset, lanes)`` ([B, k]
    lanes)."""
    vals, idx = torch.topk((logits + bias) / temperature, k, dim=-1)
    g = -torch.log(-torch.log(uniforms(seed, offset, lanes)))
    return idx.gather(1, torch.argmax(vals + g, dim=-1, keepdim=True))[:, 0]


# ---------------------------------------------------------------------------
# the NAR model
# ---------------------------------------------------------------------------

def nar_logits(params: Dict, layers: List[Dict], cfg: ValleModelConfig,
               stage: int, text_ids, prompt_codes, target_codes, pe):
    """Logits [B, N, codebook_size] fp32 of NAR stage ``stage`` (2..8) over
    the target's N frames: text [B, T], the prompt's codes [B, 8, P], the
    target's codes [B, >= stage - 1, N] (codebooks 1..stage-1 read)."""
    cdt = getattr(torch, cfg.compute_dtype)
    t, p, n = text_ids.shape[1], prompt_codes.shape[2], target_codes.shape[2]
    tables = params["audio_embeds"]
    prompt = sum(tables[j]["weight"].float()[prompt_codes[:, j]]
                 for j in range(cfg.num_codebooks))
    target = sum(tables[j]["weight"].float()[target_codes[:, j]]
                 for j in range(stage - 1))
    audio = torch.cat([prompt, target], dim=1) \
        + params["audio_alpha"].float() * pe[:p + n]
    x = torch.cat([_embed(params["text_embed"], params["text_alpha"],
                          text_ids, pe[:t]), audio], dim=1).to(cdt)
    e = params["stage_embed"]["weight"][stage - 2]
    for lp in layers:
        x = layer(lp, cfg, x, _ada(lp["norm1"], e, cfg.norm_eps),
                  _ada(lp["norm2"], e, cfg.norm_eps), attention)
    h = _ada(params["norm"], e, cfg.norm_eps)(x[:, t + p:].float())
    return torch.matmul(h, params["heads"][stage - 2]["weight"].float().t())
