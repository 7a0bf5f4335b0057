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

The train states are the JAX ones, ``{"params", "opt_state", "step"}``
with the flat AdamW state ``[{"count", "mu", "nu"}]`` (optax's empty states
hold no arrays): ``new_train_state`` wraps parameters in one,
``init_dit_train_state``, ``init_nac_train_state`` and
``init_slp_train_state`` draw one from a numpy seed, ``init_nac_frozen``
and ``init_slp_frozen`` the frozen trees of the NAC and SLP steps,
``from_jax_train_state`` and ``train_state_to_numpy`` cross it.
``ravel_tree`` is JAX's ``ravel_pytree`` order (sorted dict keys, list
indices), the layout of the flat ``mu`` and ``nu``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from . import resolve_device
from .config import (ByT5Config, CodecConfig, DiTConfig, F5DiTConfig,
                     F5PipelineConfig, GPT2Config, NACConfig, PipelineConfig,
                     SLPConfig, ValleModelConfig, VallePipelineConfig,
                     VocoderConfig, byt5_small_config)

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


def tree_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's flatten order (sorted dict keys, sequence
    indices); a path is a tuple of dict keys (str) and indices (int)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree):
    """(path, leaf) pairs in ``tree_paths`` order, the path joined as
    ``/key/0/...``."""
    for path, leaf in tree_paths(tree):
        yield "".join(f"/{p}" for p in path), leaf


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced by ``leaves``,
    which are in ``tree_leaves`` order."""
    by_path = {p: v for (p, _), v in zip(tree_leaves(template), leaves)}

    def build(node, prefix):
        if isinstance(node, Mapping):
            return {k: build(node[k], f"{prefix}/{k}") for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return by_path[prefix]

    return build(template, "")


def ravel_tree(tree):
    """(flat, unravel): the leaves concatenated in ``tree_leaves`` order
    (JAX ``ravel_pytree``'s: sorted dict keys, list indices) and the
    inverse, which returns views of a flat vector in the tree's structure."""
    leaves = [t for _, t in tree_leaves(tree)]
    shapes = [t.shape for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves])

    def unravel(vec):
        parts = torch.split(vec, [t.numel() for t in leaves])
        return tree_unflatten(tree, [v.view(s) for v, s in zip(parts, shapes)])

    return flat, unravel


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


def vq_spec(codebook_size: int, latent_dim: int):
    """codec/rvq.py init_vector_quantizer: a Xavier-uniform codebook."""
    return {"codebook": _u((codebook_size, latent_dim),
                           math.sqrt(6.0 / (codebook_size + latent_dim)))}


def nac_trainable_spec(cfg: NACConfig):
    """models/nac.py init_nac_trainable: an N(0, 1) embedding head and the
    VQ codebook, both [codebook_size, hidden_size]."""
    return {"embedding_head": {"weight": _n(
                (cfg.codebook_size, cfg.hidden_size), 1.0)},
            "vector_quantizer": vq_spec(cfg.codebook_size, cfg.hidden_size)}


def generator_spec(cfg: PipelineConfig, *, gpt2_vocab: int = 50257,
                   gpt2_positions: int = 1024, gpt2_layers: int = 12):
    """Leaf specs of the JAX init trees (GPT2 at GPT2Config's defaults and
    the NAC width, unless given)."""
    return {
        "dit": _dit_spec(cfg.dit),
        "codec": _codec_spec(cfg.codec),
        "gpt2": _gpt2_spec(cfg.nac.hidden_size, gpt2_vocab, gpt2_positions,
                           gpt2_layers),
        **nac_trainable_spec(cfg.nac),
        "vocoder": _vocoder_spec(cfg.vocoder),
    }


@dataclasses.dataclass
class F5Params:
    """The F5-TTS chain's trees: the DiT with its text embedding
    (``f5_dit_spec``) and BigVGAN."""

    dit: Dict
    vocoder: Dict


def _conv_grouped(ch: int, k: int, groups: int):
    b = 1.0 / math.sqrt(ch // groups * k)
    return {"weight": _u((ch, ch // groups, k), b), "bias": _u((ch,), b)}


def f5_dit_spec(cfg: F5DiTConfig):
    """Leaf specs of F5's DiT in the port's tree (``models/f5.py``), at
    PyTorch's default inits (``nn.Linear``, ``nn.Conv1d``: uniform over
    the fan-in bound; ``nn.Embedding``: N(0, 1)). F5 zeroes the AdaLN
    modulations and the output layers at init, and its GRN's gamma and
    beta; drawn weights stand for trained ones here, so those take the
    Linear default, and gamma and beta N(0, 0.1)."""
    d, td = cfg.dim, cfg.text_dim
    text_block = {"dwconv": _conv_grouped(td, 7, td),
                  "norm": _layer_norm(td),
                  "pwconv1": _linear(td, td * cfg.conv_mult),
                  "grn": {"gamma": _n((td * cfg.conv_mult,), 0.1),
                          "beta": _n((td * cfg.conv_mult,), 0.1)},
                  "pwconv2": _linear(td * cfg.conv_mult, td)}
    inner = cfg.heads * cfg.dim_head
    block = {"attn_norm": _linear(d, 6 * d),
             "to_q": _linear(d, inner), "to_k": _linear(d, inner),
             "to_v": _linear(d, inner), "to_out": _linear(inner, d),
             "ff1": _linear(d, cfg.ff_mult * d),
             "ff2": _linear(cfg.ff_mult * d, d)}
    conv = _conv_grouped(d, cfg.conv_pos_kernel, cfg.conv_pos_groups)
    return {
        "time_embed": {"fc1": _linear(cfg.time_freq_dim, d),
                       "fc2": _linear(d, d)},
        "text_embed": {"embed": {"weight": _n((cfg.text_num_embeds + 1,
                                               td), 1.0)},
                       "blocks": [text_block] * cfg.conv_layers},
        "input_embed": {"proj": _linear(2 * cfg.mel_dim + td, d),
                        "conv1": conv, "conv2": conv},
        "blocks": [block] * cfg.depth,
        "norm_out": _linear(d, 2 * d),
        "proj_out": _linear(d, cfg.mel_dim),
    }


def f5_spec(cfg: F5PipelineConfig):
    """Leaf specs of every tree the F5 chain reads."""
    return {"dit": f5_dit_spec(cfg.dit), "vocoder": _vocoder_spec(cfg.vocoder)}


def import_f5_state_dict(sd: Mapping[str, Any], cfg: F5DiTConfig) -> Dict:
    """F5's ``DiT.state_dict()`` (numpy arrays or CPU tensors) as the port's
    DiT tree of CPU fp32 tensors. F5's names (``backbones/dit.py``,
    ``modules.py``): ``time_embed.time_mlp.{0,2}``,
    ``text_embed.text_embed``, ``text_embed.text_blocks.{i}`` (``dwconv``,
    ``norm``, ``pwconv1``, ``grn.gamma`` / ``grn.beta`` of shape [1, 1, C],
    ``pwconv2``), ``input_embed.proj``,
    ``input_embed.conv_pos_embed.conv1d.{0,2}``,
    ``transformer_blocks.{i}`` (``attn_norm.linear``, ``attn.to_q`` /
    ``to_k`` / ``to_v``, ``attn.to_out.0``, ``ff.ff.0.0``, ``ff.ff.2``),
    ``norm_out.linear`` and ``proj_out``. A checkpoint's prefix (the CFM's
    ``transformer.``, an EMA's ``ema_model.transformer.``) is found and
    dropped; buffers (``rotary_embed.inv_freq``, the mel analysis) are not
    read."""
    mark = "time_embed.time_mlp.0.weight"
    found = [k for k in sd if k.endswith(mark)]
    if len(found) != 1:
        raise KeyError(f"no single {mark!r} in the state_dict")
    pre = found[0][:-len(mark)]

    def arr(name):
        return torch.as_tensor(np.array(sd[pre + name], dtype=np.float32,
                                        copy=True))

    def lin(name):
        return {"weight": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

    text_blocks = [{
        "dwconv": lin(f"text_embed.text_blocks.{i}.dwconv"),
        "norm": lin(f"text_embed.text_blocks.{i}.norm"),
        "pwconv1": lin(f"text_embed.text_blocks.{i}.pwconv1"),
        "grn": {"gamma": arr(f"text_embed.text_blocks.{i}.grn.gamma")
                .reshape(-1),
                "beta": arr(f"text_embed.text_blocks.{i}.grn.beta")
                .reshape(-1)},
        "pwconv2": lin(f"text_embed.text_blocks.{i}.pwconv2")}
        for i in range(cfg.conv_layers)]
    blocks = [{
        "attn_norm": lin(f"transformer_blocks.{i}.attn_norm.linear"),
        "to_q": lin(f"transformer_blocks.{i}.attn.to_q"),
        "to_k": lin(f"transformer_blocks.{i}.attn.to_k"),
        "to_v": lin(f"transformer_blocks.{i}.attn.to_v"),
        "to_out": lin(f"transformer_blocks.{i}.attn.to_out.0"),
        "ff1": lin(f"transformer_blocks.{i}.ff.ff.0.0"),
        "ff2": lin(f"transformer_blocks.{i}.ff.ff.2")}
        for i in range(cfg.depth)]
    pos = "input_embed.conv_pos_embed.conv1d"
    return {
        "time_embed": {"fc1": lin("time_embed.time_mlp.0"),
                       "fc2": lin("time_embed.time_mlp.2")},
        "text_embed": {"embed": {"weight": arr(
                           "text_embed.text_embed.weight")},
                       "blocks": text_blocks},
        "input_embed": {"proj": lin("input_embed.proj"),
                        "conv1": lin(f"{pos}.0"), "conv2": lin(f"{pos}.2")},
        "blocks": blocks,
        "norm_out": lin("norm_out.linear"),
        "proj_out": lin("proj_out"),
    }


def init_f5_params(cfg: F5PipelineConfig, seed: int = 0) -> F5Params:
    """Random CPU fp32 F5 trees (``f5_spec``) from one numpy seed."""
    return F5Params(**tree_map(torch.from_numpy,
                               fill_spec(f5_spec(cfg), seed)))


@dataclasses.dataclass
class ValleParams:
    """The VALL-E chain's trees: the AR and NAR decoders
    (``valle_spec``) and EnCodec (``_codec_spec``)."""

    ar: Dict
    nar: Dict
    codec: Dict


def _valle_layer(d: int, f: int, norm):
    """One pre-LN layer: biased attention projections, a ReLU
    feed-forward; ``norm`` the spec of each of its two norms."""
    b = 1.0 / math.sqrt(d)
    return {"norm1": norm, "norm2": norm,
            "attn": {"in_proj": {"weight": _u((3 * d, d),
                                              math.sqrt(6.0 / (4 * d))),
                                 "bias": _u((3 * d,), b)},
                     "out_proj": _linear(d, d)},
            "ff1": _linear(d, f), "ff2": _linear(f, d)}


def valle_model_spec(cfg: ValleModelConfig):
    """Leaf specs of VALL-E's AR and NAR decoders (``models/valle.py``), at
    PyTorch's default inits (``nn.Embedding`` N(0, 1), ``nn.Linear``
    uniform over the fan-in bound, the attention's in-projection Xavier
    uniform) but for its bias, which PyTorch zeroes and which is drawn
    like a Linear's so that it acts; the PE scales alpha 1, LayerNorms
    1 and 0. The AR's audio table and head take EOS (``codebook_size +
    1`` ids); the NAR's tables and its 7 heads take the codes; its
    LayerNorms are adaptive: (w, b) = Linear(stage embedding)."""
    d, f, n = cfg.d_model, cfg.ffn_dim, cfg.codebook_size
    b = 1.0 / math.sqrt(d)
    ar = {"text_embed": {"weight": _n((cfg.num_phonemes, d), 1.0)},
          "audio_embed": {"weight": _n((n + 1, d), 1.0)},
          "text_alpha": _ones((1,)), "audio_alpha": _ones((1,)),
          "layers": [_valle_layer(d, f, _layer_norm(d))] * cfg.num_layers,
          "norm": _layer_norm(d),
          "head": {"weight": _u((n + 1, d), b)}}
    ada = _linear(d, 2 * d)
    nar = {"text_embed": {"weight": _n((cfg.num_phonemes, d), 1.0)},
           "audio_embeds": [{"weight": _n((n, d), 1.0)}]
           * cfg.num_codebooks,
           "text_alpha": _ones((1,)), "audio_alpha": _ones((1,)),
           "stage_embed": {"weight": _n((cfg.num_codebooks - 1, d), 1.0)},
           "layers": [_valle_layer(d, f, ada)] * cfg.num_layers,
           "norm": ada,
           "heads": [{"weight": _u((n, d), b)}] * (cfg.num_codebooks - 1)}
    return {"ar": ar, "nar": nar}


def valle_spec(cfg: VallePipelineConfig):
    """Leaf specs of every tree the VALL-E chain reads."""
    return {**valle_model_spec(cfg.model), "codec": _codec_spec(cfg.codec)}


def init_valle_params(cfg: VallePipelineConfig, seed: int = 0) -> ValleParams:
    """Random CPU fp32 VALL-E trees (``valle_spec``) from one numpy seed."""
    return ValleParams(**tree_map(torch.from_numpy,
                                  fill_spec(valle_spec(cfg), seed)))


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


def s2t_spec(cfg):
    """models/s2t.py's init_s2t: Linear layers, LayerNorms at ones / zeros,
    N(0, 0.02) conv weights (zero bias) and token embeddings."""
    d = cfg.d_model

    def attn():
        return {k: _linear(d, d)
                for k in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def layer(ffn, cross):
        out = {"self_attn": attn(), "self_attn_layer_norm": _layer_norm(d),
               "fc1": _linear(d, ffn), "fc2": _linear(ffn, d),
               "final_layer_norm": _layer_norm(d)}
        if cross:
            out["encoder_attn"] = attn()
            out["encoder_attn_layer_norm"] = _layer_norm(d)
        return out

    convs, in_ch = [], cfg.input_features
    for i in range(cfg.num_conv_layers):
        out_ch = (cfg.conv_channels if i < cfg.num_conv_layers - 1
                  else 2 * d)
        convs.append({"weight": _n((out_ch, in_ch, cfg.conv_kernel), 0.02),
                      "bias": _zeros((out_ch,))})
        in_ch = out_ch // 2
    return {"conv": {"conv_layers": convs},
            "encoder_layers": [layer(cfg.encoder_ffn, False)]
            * cfg.encoder_layers,
            "encoder_norm": _layer_norm(d),
            "embed_tokens": {"weight": _n((cfg.vocab_size, d), 0.02)},
            "decoder_layers": [layer(cfg.decoder_ffn, True)]
            * cfg.decoder_layers,
            "decoder_norm": _layer_norm(d)}


def ecapa_spec(cfg):
    """models/ecapa.py's init_ecapa: N(0, 0.05) conv weights with zero
    biases; BatchNorms with weight 1, bias 0, running mean 0, running
    variance 1."""
    def conv(o, i, k):
        return {"weight": _n((o, i, k), 0.05), "bias": _zeros((o,))}

    def bn(c):
        return {"weight": _ones((c,)), "bias": _zeros((c,)),
                "running_mean": _zeros((c,)), "running_var": _ones((c,))}

    def tdnn(o, i, k):
        return {"conv": conv(o, i, k), "norm": bn(o)}

    c, sub = cfg.channels, cfg.channels // cfg.scale
    block = {"tdnn1": tdnn(c, c, 1),
             "res2net": {"blocks": [tdnn(sub, sub, cfg.res_kernel)]
                         * (cfg.scale - 1)},
             "tdnn2": tdnn(c, c, 1),
             "se": {"conv1": conv(cfg.se_channels, c, 1),
                    "conv2": conv(c, cfg.se_channels, 1)}}
    return {"block0": tdnn(c, cfg.input_features, cfg.kernel),
            "blocks": [block] * len(cfg.dilations),
            "mfa": tdnn(cfg.out_channels, 3 * c, 1),
            "asp": {"tdnn_conv": conv(cfg.attention_channels,
                                      3 * cfg.out_channels, 1),
                    "tdnn_norm": bn(cfg.attention_channels),
                    "conv": conv(cfg.out_channels, cfg.attention_channels,
                                 1)},
            "asp_norm": bn(2 * cfg.out_channels),
            "fc": conv(cfg.embedding_dim, 2 * cfg.out_channels, 1)}


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


def init_generator_params(cfg: PipelineConfig, seed: int = 0, *,
                          gpt2_cfg: Optional[GPT2Config] = None,
                          given: Optional[Mapping[str, Any]] = None
                          ) -> GeneratorParams:
    """Random CPU fp32 parameters with the JAX init trees' structure, shapes
    and distributions (GPT2 at ``gpt2_cfg``, by default its default size at
    the NAC width, of which the serving chain reads only ``wte``), from one
    numpy seed. The fields in ``given`` (imported weights, CPU tensors)
    replace drawn ones after the whole tree is drawn, so a random field has
    the same values whichever others are given."""
    spec = generator_spec(cfg)
    if gpt2_cfg is not None:
        spec["gpt2"] = _gpt2_spec(gpt2_cfg.n_embd, gpt2_cfg.vocab_size,
                                  gpt2_cfg.n_positions, gpt2_cfg.n_layer)
    drawn = tree_map(torch.from_numpy, fill_spec(spec, seed))
    return GeneratorParams(**{**drawn, **dict(given or {})})


def init_s2t_params(cfg, seed: int = 0, device=None) -> Dict:
    """A random fp32 S2T tree (``s2t_spec``) on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``), from a numpy seed."""
    return _draw(s2t_spec(cfg), seed, device)


def init_ecapa_params(cfg, seed: int = 0, device=None) -> Dict:
    """A random fp32 ECAPA tree (``ecapa_spec``) on ``device``, from a numpy
    seed."""
    return _draw(ecapa_spec(cfg), seed, device)


def init_slp_params(cfg: PipelineConfig, seed: int = 1,
                    byt5_cfg: Optional[ByT5Config] = None) -> Dict:
    """Random CPU fp32 ``byt5`` (byt5-small unless given) and ``slp`` trees,
    from their own numpy seed: ``dataclasses.replace(params,
    **init_slp_params(cfg))`` adds them to ``init_generator_params``'s
    tree without changing its draws."""
    spec = {"byt5": byt5_spec(byt5_cfg or byt5_small_config()),
            "slp": slp_spec(cfg.slp, cfg.codec.codebook_size)}
    return tree_map(torch.from_numpy, fill_spec(spec, seed))


# ---------------------------------------------------------------------------
# train states and the frozen trees of the training steps
# ---------------------------------------------------------------------------

def zero_adamw_state(params, flat: bool = True):
    """optax AdamW's initial state in JAX's checkpoint layout: count 0
    (int32) and zero moments, one flat vector each (``flat``, the JAX
    ``make_adamw(flat=True)``) or trees shaped as ``params``."""
    device = next(tree_leaves(params))[1].device
    if flat:
        vec, _ = ravel_tree(params)
        mu, nu = torch.zeros_like(vec), torch.zeros_like(vec)
    else:
        mu = tree_map(torch.zeros_like, params)
        nu = tree_map(torch.zeros_like, params)
    return [{"count": torch.zeros((), dtype=torch.int32, device=device),
             "mu": mu, "nu": nu}]


def new_train_state(params, flat_opt: bool = True) -> Dict:
    """``{"params", "opt_state", "step"}`` for fresh parameters: a zero
    AdamW state and step 0 (int32), on the parameters' device (the JAX
    ``build_ditto_train_step``'s ``init_state``)."""
    device = next(tree_leaves(params))[1].device
    return {"params": params, "opt_state": zero_adamw_state(params, flat_opt),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def init_dit_train_state(cfg: DiTConfig, seed: int = 0,
                         flat_opt: bool = True, device=None) -> Dict:
    """A fresh fp32 DiTTo train state on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``): the JAX ``init_ditto`` tree's structure,
    shapes and distributions from a numpy seed."""
    return new_train_state(_draw(_dit_spec(cfg), seed, device), flat_opt)


def _draw(spec, seed: int, device):
    """``fill_spec(spec, seed)`` as tensors on ``device``, resolved by
    ``resolve_device`` before anything is drawn."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(a).to(dev),
                    fill_spec(spec, seed))


def init_nac_train_state(cfg: NACConfig, seed: int = 0,
                         device=None) -> Dict:
    """A fresh NAC train state (embedding head and VQ codebook, flat AdamW)
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``), drawn from
    a numpy seed as ``models.nac.init_nac_trainable``."""
    return new_train_state(_draw(nac_trainable_spec(cfg), seed, device))


def init_slp_train_state(cfg: SLPConfig, codebook_size: int = 1024,
                         seed: int = 0, device=None,
                         flat_opt: bool = True) -> Dict:
    """A fresh SLP train state (embedding head, decoder, length predictor;
    flat AdamW unless ``flat_opt`` is False) on ``device``, drawn as
    ``models.slp.init_slp_trainable``."""
    return new_train_state(_draw(slp_spec(cfg, codebook_size), seed,
                                 device), flat_opt)


def _frozen(specs: Dict, given: Optional[Mapping[str, Any]], seed: int,
            device) -> Dict:
    """The trees of ``specs`` on ``device``: those in ``given`` (imported
    weights) moved there, the rest drawn by one ``fill_spec`` over their
    specs alone."""
    given = dict(given or {})
    dev = resolve_device(device)
    drawn = _draw({k: v for k, v in specs.items() if k not in given}, seed,
                  dev)
    return {k: tree_map(lambda t: t.to(dev), given[k]) if k in given
            else drawn[k] for k in sorted(specs)}


def init_nac_frozen(codec_cfg: CodecConfig, gpt2_cfg: GPT2Config,
                    seed: int = 0, device=None,
                    given: Optional[Mapping[str, Any]] = None) -> Dict:
    """The frozen trees the NAC step reads, ``{"codec", "gpt2"}`` (the whole
    GPT2 stack; the DiTTo step reads the same codec and GPT2's ``wte``), on
    ``device``: those in ``given`` as they are, the others drawn with the
    JAX init trees' structure, shapes and distributions, one numpy draw."""
    return _frozen({"codec": _codec_spec(codec_cfg),
                    "gpt2": _gpt2_spec(gpt2_cfg.n_embd, gpt2_cfg.vocab_size,
                                       gpt2_cfg.n_positions,
                                       gpt2_cfg.n_layer)},
                   given, seed, device)


def init_slp_frozen(codec_cfg: CodecConfig,
                    byt5_cfg: Optional[ByT5Config] = None, seed: int = 0,
                    device=None,
                    given: Optional[Mapping[str, Any]] = None) -> Dict:
    """The frozen trees the SLP step reads, ``{"byt5", "codec"}`` (ByT5-small
    unless given), on ``device``: those in ``given`` as they are, the
    others drawn, one numpy draw."""
    return _frozen({"byt5": byt5_spec(byt5_cfg or byt5_small_config()),
                    "codec": _codec_spec(codec_cfg)}, given, seed, device)


def from_jax_train_state(tree: Mapping[str, Any]) -> Dict:
    """A JAX ``{"params", "opt_state", "step"}`` train state of numpy
    arrays (optax's named tuples, or the dicts and lists a loaded
    checkpoint holds) as the port's CPU tensors, in the layout its
    checkpoints flatten to JAX's keys."""
    def conv(node):
        if hasattr(node, "_fields"):            # optax's named tuples
            return {f: conv(getattr(node, f)) for f in node._fields}
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            # optax's EmptyState entries hold no arrays and no keys
            return [conv(v) for v in node
                    if not (hasattr(v, "_fields") and not v._fields)]
        return torch.from_numpy(np.array(node, copy=True))

    return {k: conv(tree[k]) for k in ("params", "opt_state", "step")}


def train_state_to_numpy(state: Mapping[str, Any]) -> Dict:
    """The port's train state as nested dicts / lists of host numpy arrays,
    every dtype kept (count and step int32)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), dict(state))
