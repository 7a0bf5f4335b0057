"""GPT2 (the JAX package's ``text/gpt2.py``; HF-weight compatible).

Two uses, as in the reference:
  * the NAC's alignment loss: the whole decoder stack over codec latent
    embeddings (``inputs_embeds``), text ids as labels (``lm_loss``, HF's
    shifted cross-entropy);
  * the DiT's text conditioning: the raw ``wte`` lookup (``embed_tokens``).

gpt2-small's stack: learned positions, pre-LN blocks, HF ``Conv1D`` layout
(weights [in, out]), ``gelu_new``, the LM head tied to ``wte``. Attention is
JAX's math and no kernel: fp32 scores, an additive bias of -1e9 above the
diagonal and -1e9 on padded keys, the softmax, the probabilities cast to
v's type, times v (``ops.attention.attention_plain`` with that bias, as
ByT5 calls it). Kernel A is not used: JAX does not send GPT2 to Pallas, and
its padding is an additive bias, not a kv length. ``gelu_new`` is shared
with ByT5's feed-forward.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..config import GPT2Config
from ..nn.core import layer_norm
from ..ops.attention import attention_plain


def embed_tokens(params, ids):
    """Raw wte lookup: ids [B, St] -> [B, St, n_embd]."""
    return params["wte"]["weight"][ids]


def gelu_new(x):
    """HF 'gelu_new', the tanh approximation, computed in fp32 and cast
    back to x's type."""
    c = math.sqrt(2.0 / math.pi)
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(c * (xf + 0.044715 * torch.pow(xf, 3.0))))
    return y.to(x.dtype)


def _conv1d_hf(params, x):
    """HF GPT2 'Conv1D': ``x @ W + b`` with W stored [in, out], summed in
    fp32 and cast to x's type before the bias."""
    y = torch.matmul(x.float(), params["weight"].float()).to(x.dtype)
    return y + params["bias"]


def _attn(block, cfg: GPT2Config, x, attn_bias):
    b, s, h = x.shape
    nh, d = cfg.n_head, h // cfg.n_head
    q, k, v = _conv1d_hf(block["attn"]["c_attn"], x).split(h, dim=-1)

    def heads(t):
        return t.reshape(b, s, nh, d).transpose(1, 2)

    out = attention_plain(heads(q), heads(k), heads(v), bias=attn_bias)
    return _conv1d_hf(block["attn"]["c_proj"],
                      out.transpose(1, 2).reshape(b, s, h))


def _block(block, cfg: GPT2Config, x, attn_bias):
    eps = cfg.layer_norm_epsilon
    x = x + _attn(block, cfg, layer_norm(block["ln_1"], x, eps=eps), attn_bias)
    h = layer_norm(block["ln_2"], x, eps=eps)
    h = gelu_new(_conv1d_hf(block["mlp"]["c_fc"], h))
    return x + _conv1d_hf(block["mlp"]["c_proj"], h)


def gpt2_hidden_states(params, cfg: GPT2Config, inputs_embeds,
                       attention_mask=None):
    """The stack on embeddings: inputs_embeds [B, S, H] -> [B, S, H];
    ``attention_mask`` [B, S] (1 = real token)."""
    s, dev = inputs_embeds.shape[1], inputs_embeds.device
    x = inputs_embeds + params["wpe"]["weight"][:s]
    # -1e9 above the diagonal (the causal mask), 0 elsewhere
    bias = torch.full((s, s), -1e9, device=dev).triu(1)[None, None]
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float()) * -1e9
        bias = bias + pad[:, None, None, :]
    for blk in params["h"]:
        x = _block(blk, cfg, x, bias)
    return layer_norm(params["ln_f"], x, eps=cfg.layer_norm_epsilon)


def gpt2_logits(params, cfg: GPT2Config, inputs_embeds, attention_mask=None):
    """The tied LM head: ``h @ wte.T``, fp32 [B, S, vocab]."""
    h = gpt2_hidden_states(params, cfg, inputs_embeds, attention_mask)
    return torch.matmul(h.float(), params["wte"]["weight"].float().t())


def lm_loss(logits, labels):
    """HF's causal-LM loss: logits shifted against labels, mean CE over
    positions, no ignore index (the reference passes raw ids as labels,
    ref NeuralAudioCodec.py:52-56). One log-softmax and a gather over the
    [B, S-1, vocab] view, no other copy of the logits."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, labels[:, 1:, None].long())[..., 0]
    return nll.mean()


def import_hf_state_dict(sd: Dict[str, np.ndarray],
                         cfg: GPT2Config) -> Dict:
    """An HF GPT2LMHeadModel (or GPT2Model) state dict (numpy arrays or CPU
    tensors) as the param tree of CPU tensors."""
    p = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def arr(name):
        return torch.from_numpy(np.array(sd[name], copy=True))

    def c1d(prefix):
        return {"weight": arr(f"{prefix}.weight"),
                "bias": arr(f"{prefix}.bias")}

    blocks = []
    for i in range(cfg.n_layer):
        b = f"{p}h.{i}"
        blocks.append({
            "ln_1": c1d(f"{b}.ln_1"),
            "attn": {"c_attn": c1d(f"{b}.attn.c_attn"),
                     "c_proj": c1d(f"{b}.attn.c_proj")},
            "ln_2": c1d(f"{b}.ln_2"),
            "mlp": {"c_fc": c1d(f"{b}.mlp.c_fc"),
                    "c_proj": c1d(f"{b}.mlp.c_proj")},
        })
    return {
        "wte": {"weight": arr(f"{p}wte.weight")},
        "wpe": {"weight": arr(f"{p}wpe.weight")},
        "h": blocks,
        "ln_f": c1d(f"{p}ln_f"),
    }
