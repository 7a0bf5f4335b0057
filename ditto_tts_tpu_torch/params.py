"""The port's parameters: the JAX package's ``GeneratorParams`` trees as
nested dicts and lists of torch tensors.

The JAX package already keeps torch layouts (``dense`` is ``x @ W.T + b``,
convs are [out, in, k], transposed convs [in, out, k], the LSTM has torch's
gate order), so ``from_jax_params`` converts leaves and changes nothing
else. ``init_generator_params`` makes a random tree of the same structure,
shapes and init distributions as the JAX ``init_*`` functions from a numpy
seed, for runs that have no JAX (the card's machine); ``init_slp_params``
does the same for the SLP chain's ByT5 and SLP trees, in a draw of its own
so the six serving fields keep their values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .config import (ByT5Config, CodecConfig, DiTConfig, PipelineConfig,
                     SLPConfig, VocoderConfig, byt5_small_config)

FIELDS = ("dit", "codec", "gpt2", "embedding_head", "vector_quantizer",
          "vocoder")
SLP_FIELDS = ("byt5", "slp")     # only the SLP chain reads them


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of nested dicts / lists / tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs in a fixed order (sorted dict keys)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@dataclasses.dataclass
class GeneratorParams:
    """Every parameter tree the serving chain reads."""

    dit: Dict
    codec: Dict
    gpt2: Dict
    embedding_head: Dict          # NAC: codes -> 768-wide latents
    vector_quantizer: Dict        # NAC: latents -> code indices
    vocoder: Dict
    byt5: Optional[Dict] = None
    slp: Optional[Dict] = None

    def to(self, device) -> "GeneratorParams":
        return GeneratorParams(**{
            f: tree_map(lambda t: t.to(device), getattr(self, f))
            for f in FIELDS + SLP_FIELDS if getattr(self, f) is not None})


def from_jax_params(tree: Mapping[str, Any]) -> GeneratorParams:
    """The JAX ``GeneratorParams`` fields (a mapping of field name to nested
    dicts / lists of numpy arrays; ``byt5`` and ``slp`` where present and
    not None) as the port's CPU tensors. Leaves keep their shapes, values
    and dtypes."""
    return GeneratorParams(**{
        f: tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                    tree[f]) for f in FIELDS + SLP_FIELDS
        if tree.get(f) is not None})


# ---------------------------------------------------------------------------
# random init: the JAX init trees, leaf specs filled from one numpy seed
# ---------------------------------------------------------------------------
# a leaf spec is (shape, kind, scale): kind "u" uniform(-scale, scale),
# "n" normal(0, scale), "1" ones, "0" zeros

def _u(shape, bound):
    return (tuple(shape), "u", float(bound))


def _n(shape, std):
    return (tuple(shape), "n", float(std))


def _ones(shape):
    return (tuple(shape), "1", 0.0)


def _zeros(shape):
    return (tuple(shape), "0", 0.0)


def _linear(din, dout):
    """nn/core.py Linear: kaiming-uniform weight, fan-in uniform bias."""
    b = 1.0 / math.sqrt(din)
    return {"weight": _u((dout, din), b), "bias": _u((dout,), b)}


def _layer_norm(h):
    return {"weight": _ones((h,)), "bias": _zeros((h,))}


def _mha(h):
    return {"in_proj_weight": _u((3 * h, h), math.sqrt(6.0 / (4 * h))),
            "in_proj_bias": _zeros((3 * h,)),
            "out_proj": _linear(h, h)}


def _dit_spec(cfg: DiTConfig):
    h, m = cfg.hidden_dim, cfg.mlp_ratio * cfg.hidden_dim
    block = {"norm1": _layer_norm(h), "attn": _mha(h), "norm2": _layer_norm(h),
             "cross_attn": _mha(h), "norm3": _layer_norm(h),
             "mlp_fc1": _linear(h, m), "gate": _linear(h, m),
             "mlp_fc2": _linear(m, h)}
    return {
        "t_embedding": {"weight": _n((cfg.diffusion_steps, cfg.time_dim), 1.0)},
        "time_embed": {"fc1": _linear(cfg.time_dim, cfg.time_dim),
                       "fc2": _linear(cfg.time_dim, cfg.time_dim)},
        "ada_ln": {"time_mlp": _linear(cfg.time_dim, 2 * h),
                   "text_mlp": _linear(cfg.text_dim, 2 * h)},
        "proj_in": _linear(h, h),
        "proj_out": _linear(h, h),
        "blocks": [block] * cfg.num_layers,
    }


def _conv(out_ch, in_ch, k):
    b = 1.0 / math.sqrt(in_ch * k)
    return {"weight": _u((out_ch, in_ch, k), b), "bias": _u((out_ch,), b)}


def _convtr(in_ch, out_ch, k):
    b = 1.0 / math.sqrt(out_ch * k)
    return {"weight": _u((in_ch, out_ch, k), b), "bias": _u((out_ch,), b)}


def _lstm(size, layers):
    b = 1.0 / math.sqrt(size)
    return [{"weight_ih": _u((4 * size, size), b),
             "weight_hh": _u((4 * size, size), b),
             "bias_ih": _u((4 * size,), b),
             "bias_hh": _u((4 * size,), b)}] * layers


def _resblock(cfg: CodecConfig, dim):
    hidden = dim // cfg.compress
    return {"conv1": _conv(hidden, dim, cfg.residual_kernel_size),
            "conv2": _conv(dim, hidden, 1),
            "shortcut": _conv(dim, dim, 1)}


def _codec_spec(cfg: CodecConfig):
    ch = cfg.num_filters
    enc = {"init_conv": _conv(ch, cfg.channels, cfg.kernel_size)}
    stages = []
    for ratio in reversed(cfg.ratios):
        stages.append({"resblocks": [_resblock(cfg, ch)]
                       * cfg.num_residual_layers,
                       "down": _conv(2 * ch, ch, 2 * ratio)})
        ch *= 2
    enc["stages"] = stages
    enc["lstm"] = _lstm(ch, cfg.lstm_layers)
    enc["final_conv"] = _conv(cfg.dimension, ch, cfg.last_kernel_size)

    ch = cfg.num_filters * 2 ** len(cfg.ratios)
    dec = {"init_conv": _conv(ch, cfg.dimension, cfg.kernel_size),
           "lstm": _lstm(ch, cfg.lstm_layers)}
    stages = []
    for ratio in cfg.ratios:
        stages.append({"up": _convtr(ch, ch // 2, 2 * ratio),
                       "resblocks": [_resblock(cfg, ch // 2)]
                       * cfg.num_residual_layers})
        ch //= 2
    dec["stages"] = stages
    dec["final_conv"] = _conv(cfg.channels, ch, cfg.last_kernel_size)
    return {"encoder": enc, "decoder": dec,
            "quantizer": {"codebooks": _n((cfg.num_quantizers,
                                           cfg.codebook_size,
                                           cfg.dimension), 1.0)}}


def _gpt2_spec(h, vocab, n_positions, n_layer):
    """text/gpt2.py init_gpt2 at GPT2Config() with n_embd = h."""
    def c1d(din, dout):
        return {"weight": _n((din, dout), 0.02), "bias": _zeros((dout,))}

    block = {"ln_1": _layer_norm(h),
             "attn": {"c_attn": c1d(h, 3 * h), "c_proj": c1d(h, h)},
             "ln_2": _layer_norm(h),
             "mlp": {"c_fc": c1d(h, 4 * h), "c_proj": c1d(4 * h, h)}}
    return {"wte": {"weight": _n((vocab, h), 0.02)},
            "wpe": {"weight": _n((n_positions, h), 0.01)},
            "h": [block] * n_layer,
            "ln_f": _layer_norm(h)}


def _vocoder_spec(cfg: VocoderConfig):
    ch = cfg.upsample_initial_channel
    ups, resblocks = [], []
    for i, _ in enumerate(cfg.upsample_rates):
        ups.append(_convtr(ch, ch // 2, cfg.upsample_kernel_sizes[i]))
        ch //= 2
        act = {"alpha": _zeros((ch,)), "beta": _zeros((ch,))}
        resblocks.append([
            {"convs1": [_conv(ch, ch, rk)] * len(dils),
             "convs2": [_conv(ch, ch, rk)] * len(dils),
             "act1": [act] * len(dils), "act2": [act] * len(dils)}
            for rk, dils in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilation_sizes)])
    return {"conv_pre": _conv(cfg.upsample_initial_channel, cfg.num_mels, 7),
            "ups": ups, "resblocks": resblocks,
            "act_post": {"alpha": _zeros((ch,)), "beta": _zeros((ch,))},
            "conv_post": {"weight": _conv(1, ch, 7)["weight"]}}


def generator_spec(cfg: PipelineConfig, *, gpt2_vocab: int = 50257,
                   gpt2_positions: int = 1024, gpt2_layers: int = 12):
    """Leaf specs of the JAX init trees (GPT2 at GPT2Config's defaults and
    the NAC width, unless given)."""
    h = cfg.nac.hidden_size
    return {
        "dit": _dit_spec(cfg.dit),
        "codec": _codec_spec(cfg.codec),
        "gpt2": _gpt2_spec(h, gpt2_vocab, gpt2_positions, gpt2_layers),
        "embedding_head": {"weight": _n((cfg.nac.codebook_size, h), 1.0)},
        "vector_quantizer": {"codebook": _u(
            (cfg.nac.codebook_size, h),
            math.sqrt(6.0 / (cfg.nac.codebook_size + h)))},
        "vocoder": _vocoder_spec(cfg.vocoder),
    }


def byt5_spec(cfg: ByT5Config):
    """text/byt5.py init_byt5: normals, RMS weights 1."""
    d, nh, dff, inner = cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.inner_dim
    block = {
        "attn": {"q": {"weight": _n((inner, d), (d * cfg.d_kv) ** -0.5)},
                 "k": {"weight": _n((inner, d), d ** -0.5)},
                 "v": {"weight": _n((inner, d), d ** -0.5)},
                 "o": {"weight": _n((d, inner), inner ** -0.5)}},
        "attn_norm": {"weight": _ones((d,))},
        "ff": {"wi_0": {"weight": _n((dff, d), d ** -0.5)},
               "wi_1": {"weight": _n((dff, d), d ** -0.5)},
               "wo": {"weight": _n((d, dff), dff ** -0.5)}},
        "ff_norm": {"weight": _ones((d,))},
    }
    return {"shared": {"weight": _n((cfg.vocab_size, d), 1.0)},
            "block0_rel": {"relative_attention_bias": {"weight": _n(
                (cfg.relative_attention_num_buckets, nh), inner ** -0.5)}},
            "blocks": [block] * cfg.num_layers,
            "final_norm": {"weight": _ones((d,))}}


def slp_spec(cfg: SLPConfig, codebook_size: int):
    """models/slp.py init_slp_trainable: an N(0, 1) embedding head, the
    decoder layers (MHA as the DiT's, FF width embedding_dim * num_heads)
    and the length predictor."""
    d = cfg.embedding_dim
    ff = d * cfg.num_heads
    layer = {"self_attn": _mha(d), "cross_attn": _mha(d),
             "linear1": _linear(d, ff), "linear2": _linear(ff, d),
             "norm1": _layer_norm(d), "norm2": _layer_norm(d),
             "norm3": _layer_norm(d)}
    return {"embedding_head": {"weight": _n((codebook_size, d), 1.0)},
            "decoder": [layer] * cfg.num_layers,
            "length_predictor": _linear(d, cfg.nb_classes)}


def fill_spec(spec, seed: int):
    """numpy fp32 arrays for a spec tree, drawn leaf by leaf in sorted-key
    order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, tuple):
            shape, kind, scale = node
            if kind == "u":
                return np.float32(2 * scale) * rng.random(shape, np.float32) \
                    - np.float32(scale)
            if kind == "n":
                return scale * rng.standard_normal(shape, np.float32)
            return (np.ones if kind == "1" else np.zeros)(shape, np.float32)
        if isinstance(node, Mapping):
            return {k: fill(node[k]) for k in sorted(node)}
        return [fill(v) for v in node]

    return fill(spec)


def init_generator_params(cfg: PipelineConfig,
                          seed: int = 0) -> GeneratorParams:
    """Random CPU fp32 parameters with the JAX init trees' structure, shapes
    and distributions (GPT2 at its default size, of which the serving chain
    reads only ``wte``), from one numpy seed."""
    return from_jax_params(fill_spec(generator_spec(cfg), seed))


def init_slp_params(cfg: PipelineConfig, seed: int = 1,
                    byt5_cfg: Optional[ByT5Config] = None) -> Dict:
    """Random CPU fp32 ``byt5`` (byt5-small unless given) and ``slp`` trees,
    from their own numpy seed: ``dataclasses.replace(params,
    **init_slp_params(cfg))`` adds them to ``init_generator_params``'s
    tree without changing its draws."""
    spec = {"byt5": byt5_spec(byt5_cfg or byt5_small_config()),
            "slp": slp_spec(cfg.slp, cfg.codec.codebook_size)}
    return tree_map(torch.from_numpy, fill_spec(spec, seed))
