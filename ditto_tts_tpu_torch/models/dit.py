"""DiT diffusion transformer (the JAX package's ``models/dit.py``).

  * GlobalAdaLN: time+text conditioned scale/shift applied once before the
    block stack (``scale = 1 + time_scale + text_scale``, mean-pooled text,
    non-affine LN).
  * DiTBlock: self-attention with RoPE, cross-attention to the text, gated
    MLP (exact GELU times a sigmoid gate).
  * DiTTO: timestep embedding + SiLU MLP, the shared GlobalAdaLN, N blocks
    and a long skip through proj_in/proj_out.

``ref_compat`` (quirk #2) skips the self-attention ``out_proj``.
``import_reference_state_dict`` maps the reference's ``DiTTO.state_dict()``
names into the tree.

Per-request work is hoisted out of the denoising loop by ``prepare``: the
block parameters are cast to the compute dtype once (the JAX
``prepare_blocks``), every layer's cross-attention K/V is projected from
the text once (``prepare_cross_kv``) and the RoPE tables are built once.
The block stack is a Python loop (``scan_blocks`` changes nothing).
Attention goes through ``ops.attention.attention`` (kernel A on the card,
differentiable), heads wider than 128 through the matmul-softmax math, as
JAX dispatches them; the dense layers are ``torch.matmul``.

Training (``train/steps.py``) calls ``ditto_forward`` with a
``torch.Generator`` in place of JAX's ``dropout_key``:
  * cross-attention dropout of rate ``cross_attn_dropout``, inverted (kept
    values scaled by 1/(1-rate)), on the projected cross-attention output
    (``attn_dropout_mode="output"``) or on the matmul-softmax probabilities
    (``"probs"``, forced by ``ref_compat``; that path computes the
    attention inline, not on kernel A, as JAX does). JAX's RBG mask cannot
    be replayed; any iid keep mask is the same regularizer. Every block's
    mask is drawn before the block runs, so a rematerialized block reuses
    it (checkpoint's RNG replay covers only the default generators);
  * ``remat_blocks``: each block under ``torch.utils.checkpoint`` (not
    reentrant). ``remat_policy="nothing_saveable"`` recomputes all of it,
    ``"dots_with_no_batch_dims_saveable"`` saves the weight GEMMs' outputs
    (``aten.mm`` / ``addmm``) and recomputes the rest, attention included.
With gradients, ``prepare`` runs inside every forward, so its bf16 casts
and cross K/V stay in the autograd graph of that step's parameters.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..config import DiTConfig
from ..nn.core import dense, embed, layer_norm
from ..ops.attention import attention, attention_plain
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


def _dropout_mode(cfg: DiTConfig) -> str:
    return "probs" if cfg.ref_compat else cfg.attn_dropout_mode


def _inverted(x, keep, rate: float):
    """The JAX ``_rbg_dropout`` given its keep mask: kept values scaled by
    1/(1-rate), the rest 0."""
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((),
                       dtype=x.dtype, device=x.device))


def draw_keep_masks(cfg: DiTConfig, generator: torch.Generator, b: int,
                    s: int, st: int, device) -> List:
    """One cross-attention dropout keep mask per block (True with
    probability 1 - rate): [B, S, H] for ``"output"`` dropout, [B, nh, S,
    St] for ``"probs"``."""
    shape = ((b, s, cfg.hidden_dim) if _dropout_mode(cfg) == "output"
             else (b, cfg.num_heads, s, st))
    return [torch.rand(shape, generator=generator, device=device)
            >= cfg.cross_attn_dropout for _ in range(cfg.num_layers)]


def _attend(q, k, v):
    """``ops.attention.attention`` (kernel A on the card) for heads up to
    128 wide; a wider head (``ref_trained_dit_config``'s one head of 768)
    takes the matmul-softmax math on any device, as the JAX ``attention``
    dispatch sends it to ``sdpa_reference`` (Pallas and kernel A take head
    dims up to 128)."""
    if q.shape[-1] > 128:
        return attention_plain(q, k, v)
    return attention(q, k, v)


def dit_block(params, cfg: DiTConfig, x, rope_cs: Tuple, cross_kv: Tuple,
              keep=None):
    """One DiT block. rope_cs = (cos, sin); cross_kv = this layer's (K, V);
    ``keep`` this layer's cross-attention dropout keep mask
    (``draw_keep_masks``), None for no dropout."""
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
    attn_out = _merge_heads(_attend(q, k, v))
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
    rate = cfg.cross_attn_dropout
    if keep is not None and _dropout_mode(cfg) == "probs":
        # torch MHA semantics, computed inline as JAX does (not kernel A)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(q.shape[-1])
        p = _inverted(torch.softmax(scores, dim=-1), keep, rate)
        heads = torch.matmul(p.to(v.dtype).float(), v.float()).to(x.dtype)
    else:
        heads = _attend(q, k, v)
    cross = dense(params["cross_attn"]["out_proj"], _merge_heads(heads))
    if keep is not None and _dropout_mode(cfg) == "output":
        cross = _inverted(cross, keep, rate)
    x = cross + residual

    # gated MLP
    residual = x
    xn = layer_norm(params["norm3"], x)
    up = F.gelu(dense(params["mlp_fc1"], xn))
    gate = torch.sigmoid(dense(params["gate"], xn))
    return dense(params["mlp_fc2"], up * gate) + residual


_WEIGHT_GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_gemms(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: the outputs of the weight
    GEMMs ([B, S, H] x W^T folds to one ``mm``) are saved; everything
    else, the batched attention products included, is recomputed."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _WEIGHT_GEMMS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("nothing_saveable", "dots_with_no_batch_dims_saveable")


def _remat(cfg: DiTConfig):
    """dit_block under ``torch.utils.checkpoint`` with ``cfg.remat_policy``."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"expected one of {REMAT_POLICIES}")
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots_with_no_batch_dims_saveable":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_weight_gemms)
    return functools.partial(ckpt.checkpoint, dit_block, **kw)


def ditto_forward(params, cfg: DiTConfig, x, text_emb, t, *,
                  prepared: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
    """Noise prediction. x: [B, S, H] noisy latents; text_emb: [B, St, Xd];
    t: [B] int. ``prepared`` is ``prepare(...)`` for this request;
    ``generator`` (on x's device) draws the cross-attention dropout masks,
    None for none (the JAX ``dropout_key``). ``cfg.remat_blocks``
    rematerializes each block where autograd records the forward."""
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
    keeps = [None] * cfg.num_layers
    if generator is not None and cfg.cross_attn_dropout > 0.0:
        keeps = draw_keep_masks(cfg, generator, x.shape[0], x.shape[1],
                                text_emb.shape[1], x.device)
    block = dit_block
    if cfg.remat_blocks and torch.is_grad_enabled():
        block = _remat(cfg)
    for blk, ckv, keep in zip(prepared["blocks"], prepared["cross_kv"],
                              keeps):
        x = block(blk, cfg, x, prepared["rope"], ckv, keep)

    x = dense(params["proj_out"], x.to(x_skip.dtype))
    return x_skip + x


def import_reference_state_dict(sd, cfg: DiTConfig) -> Dict:
    """A reference ``DiTTO.state_dict()`` (numpy arrays or CPU tensors) as
    the param tree of CPU tensors. Reference names (ref
    src/model/DiTTO.py:37-57, src/components/DiT.py:8-98): ``t_embedding``,
    ``time_embed.{0,2}`` (a Sequential), ``ada_ln.{time,text}_mlp.1``
    (Sequential(SiLU, Linear)), ``blocks.{i}`` with ``norm{1,2,3}``,
    ``attn`` / ``cross_attn`` (torch MultiheadAttention: packed
    ``in_proj_*`` and ``out_proj``), ``mlp_fc1`` / ``gate`` / ``mlp_fc2``,
    and ``proj_in`` / ``proj_out``. Buffers (``alphas_cumprod``,
    ``rotary.inv_freq``) and the frozen ``nac.*`` subtree are ignored."""
    def arr(name):
        return torch.from_numpy(np.array(sd[name], copy=True))

    def lin(prefix):
        out = {"weight": arr(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            out["bias"] = arr(f"{prefix}.bias")
        return out

    def mha(prefix):
        return {"in_proj_weight": arr(f"{prefix}.in_proj_weight"),
                "in_proj_bias": arr(f"{prefix}.in_proj_bias"),
                "out_proj": lin(f"{prefix}.out_proj")}

    blocks = []
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        blocks.append({
            "norm1": lin(f"{b}.norm1"), "attn": mha(f"{b}.attn"),
            "norm2": lin(f"{b}.norm2"),
            "cross_attn": mha(f"{b}.cross_attn"),
            "norm3": lin(f"{b}.norm3"), "mlp_fc1": lin(f"{b}.mlp_fc1"),
            "gate": lin(f"{b}.gate"), "mlp_fc2": lin(f"{b}.mlp_fc2")})
    return {
        "t_embedding": {"weight": arr("t_embedding.weight")},
        "time_embed": {"fc1": lin("time_embed.0"),
                       "fc2": lin("time_embed.2")},
        "ada_ln": {"time_mlp": lin("ada_ln.time_mlp.1"),
                   "text_mlp": lin("ada_ln.text_mlp.1")},
        "proj_in": lin("proj_in"),
        "proj_out": lin("proj_out"),
        "blocks": blocks,
    }
