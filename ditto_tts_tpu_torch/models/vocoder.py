"""BigVGAN v2 generator (24 kHz / 100-band / 256x), the JAX
``models/vocoder.py`` with its ``aa_impl`` / ``layout`` / ``conv_impl``
dispatch as it runs on the TPU (Pallas available).

  conv_pre (k=7) -> 6 stages of [polyphase upsample (4,4,2,2,2,2), mean of
  3 AMP residual blocks (k = 3,7,11; dilations 1,3,5)] -> anti-aliased
  SnakeBeta -> conv_post (k=7, no bias) -> clamp [-1, 1].

``import_bigvgan_state_dict`` maps a BigVGAN generator state dict into the
tree.

The signal is carried [B, C, T] throughout in ``cfg.carry_dtype`` and
every conv is kernel B (operands in ``cfg.compute_dtype``, fp32 sums): the
JAX channels-last carry and its NLC/NCL hybrid were TPU lane-padding
devices that change only the order of summation. What follows the JAX
package is which activation runs where. "Hybrid" is ``layout="nlc"`` with
``conv_impl="pallas"``: from the first upsample to fewer than 96 channels
on, the JAX package carries the stage time-minor ("NCL-hybrid"); the other
stages of the nlc layout are "NLC" stages. W is the stage's width.

  where                     fused_conv     polyphase  polyphase_gemm  composed  fused_pallas        fused_ncl
  layout "ncl", every act   polyphase      polyphase  composed        composed  fused_snake (#8)    composed
  NLC stage, AMP acts       C pairs at     polyphase  banded GEMM     raises    fused_snake_nlc     raises
                            96<=W<=384,                                         (#9) at W >= 96,
                            else polyphase                                      else polyphase
  NCL-hybrid stage, AMP     polyphase      polyphase  composed        composed  fused_snake (#8)    C pairs, residual
  acts                                                                                              in the second
  act_post after an NCL-hybrid stage: polyphase, whatever aa_impl
  act_post after an NLC stage: a standalone NLC act (fused_conv: polyphase)

"C pairs" run each act->conv pair as one call of kernel C
(``ops.act_conv``); "raises" is the JAX package's NotImplementedError. As
in the JAX package, the fused kernels (C and D, as their Pallas
counterparts) take the pi-periodic polynomial sin^2 (``ops.snake.sin2``,
within ~5e-7 of sin^2 for |alpha x| <~ 1e3, more beyond), and so do the
polyphase activations that ``fused_conv`` runs under ``layout="nlc"`` (the
JAX ``fast`` flag: NLC stages, NCL-hybrid stages and act_post); every
other polyphase, composed and banded-GEMM form takes ``torch.sin``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..codec.encodec import _fold_weight_norm
from ..config import VocoderConfig
from ..nn.conv import conv_transpose1d_poly
from ..ops.act_conv import aa_snake_conv1d, aa_snake_conv1d_ncl
from ..ops.conv import conv1d
from ..ops.snake import (anti_aliased_activation,
                         polyphase_anti_aliased_activation,
                         polyphase_anti_aliased_activation_gemm, snake_beta)
from ..ops.snake_fused import fused_snake, fused_snake_nlc

FUSED_WIDTHS = (96, 384)   # the JAX fused_conv dispatch band, inclusive
NARROW = 96                # below: NCL-hybrid stages, no fused_snake_nlc


def _get_padding(k: int, d: int) -> int:
    return (k * d - d) // 2


def _beta(act_params, cfg: VocoderConfig):
    return act_params["beta"] if cfg.activation == "snakebeta" else None


def _snake_fn(act_params, cfg: VocoderConfig, fast: bool):
    alpha, beta = act_params["alpha"], _beta(act_params, cfg)
    return lambda v: snake_beta(v, alpha, beta, logscale=cfg.snake_logscale,
                                fast=fast)


def _act(x, act_params, cfg: VocoderConfig, impl: str, fast: bool = False):
    """A standalone activation where the JAX package carries [B, C, T];
    ``fast``: sin^2 by ``sin2`` (the JAX ``_act(fast=...)``)."""
    fn = _snake_fn(act_params, cfg, fast)
    if not cfg.use_anti_aliasing:
        return fn(x)
    if impl == "fused_pallas":
        # the JAX _act hands over any beta the parameters hold
        return fused_snake(x, act_params["alpha"], act_params.get("beta"),
                           logscale=cfg.snake_logscale)
    if impl == "polyphase":
        return polyphase_anti_aliased_activation(x, fn)
    return anti_aliased_activation(x, fn)


def _act_nlc(x, act_params, cfg: VocoderConfig, impl: str):
    """A standalone activation of a channels-last stage (the JAX
    ``_act_nlc``), on the [B, C, T] carry; under ``fused_conv`` the
    polyphase form with ``sin2``."""
    fast = impl == "fused_conv"
    fn = _snake_fn(act_params, cfg, fast)
    if not cfg.use_anti_aliasing:
        return fn(x)
    if fast:
        impl = "polyphase"
    if impl == "fused_pallas":
        if x.shape[1] >= NARROW:
            return fused_snake_nlc(
                x.transpose(1, 2), act_params["alpha"],
                _beta(act_params, cfg),
                logscale=cfg.snake_logscale).transpose(1, 2)
        impl = "polyphase"
    if impl == "polyphase_gemm":
        return polyphase_anti_aliased_activation_gemm(x, fn)
    if impl != "polyphase":
        raise NotImplementedError(
            "nlc layout supports aa_impl in ('polyphase', 'polyphase_gemm',"
            f" 'fused_pallas') only (got {impl!r}); use layout='ncl' for "
            "the oracle paths")
    return polyphase_anti_aliased_activation(x, fn)


def _conv_same(p, x, *, dilation: int = 1, cdt=None):
    pad = _get_padding(p["weight"].shape[-1], dilation)
    return conv1d(F.pad(x, (pad, pad)), p["weight"], p.get("bias"),
                  dilation=dilation, compute_dtype=cdt)


def _amp_block(p, x, dilations, cdt, act):
    """AMPBlock1: [act, dilated conv, act, conv] x len(dilations), residual;
    ``act(x, act_params)`` is the stage's standalone activation."""
    for i in range(len(p["convs1"])):
        xt = act(x, p["act1"][i])
        xt = _conv_same(p["convs1"][i], xt, dilation=dilations[i], cdt=cdt)
        xt = act(xt, p["act2"][i])
        xt = _conv_same(p["convs2"][i], xt, cdt=cdt)
        x = x + xt
    return x


def _amp_block_pairs(p, cfg: VocoderConfig, x, dilations, cdt,
                     residual: bool):
    """AMPBlock1 with each act->conv pair one kernel C call: the JAX
    ``aa_snake_conv1d`` pairs (NLC stages) or, with ``residual``, the
    time-minor ``aa_snake_conv1d_ncl`` pairs with the residual added in the
    second pair's epilogue (NCL-hybrid stages)."""
    for i in range(len(p["convs1"])):
        pairs = ((p["act1"][i], p["convs1"][i], dilations[i]),
                 (p["act2"][i], p["convs2"][i], 1))
        xt = x
        for j, (act, conv, dil) in enumerate(pairs):
            kw = dict(dilation=dil, logscale=cfg.snake_logscale,
                      compute_dtype=cdt)
            args = (xt, act["alpha"], _beta(act, cfg), conv["weight"],
                    conv.get("bias"))
            if not residual:
                xt = aa_snake_conv1d(*args, **kw)
            elif j == 0:
                xt = aa_snake_conv1d_ncl(*args, **kw)
            else:
                xt = aa_snake_conv1d_ncl(*args, residual=x, **kw)
        x = xt if residual else x + xt
    return x


def _stage_block(cfg: VocoderConfig, impl: str, kind: str, width: int, cdt):
    """The AMP block of a stage of ``kind`` ("ncl" layout, "nlc" or
    "hybrid" stage) at ``width`` channels, as a function (p, x, dils)."""
    aa = cfg.use_anti_aliasing
    if kind == "nlc":
        lo, hi = FUSED_WIDTHS
        if impl == "fused_conv" and aa and lo <= width <= hi:
            return lambda p, x, d: _amp_block_pairs(p, cfg, x, d, cdt, False)

        def act(v, a):
            return _act_nlc(v, a, cfg, impl)
    else:
        if kind == "hybrid" and impl == "fused_ncl" and aa:
            return lambda p, x, d: _amp_block_pairs(p, cfg, x, d, cdt, True)
        act_impl = impl
        if impl == "fused_conv" or (kind == "hybrid" and impl == "fused_ncl"):
            act_impl = "polyphase"
        # the JAX _amp_block_ncl sets fast under fused_conv; the "ncl"
        # layout maps fused_conv to the exact polyphase form
        fast = kind == "hybrid" and impl == "fused_conv"

        def act(v, a):
            return _act(v, a, cfg, act_impl, fast)
    return lambda p, x, d: _amp_block(p, x, d, cdt, act)


def bigvgan_forward(params, cfg: VocoderConfig, mel, *, fused: bool = False,
                    aa_impl: Optional[str] = None,
                    layout: Optional[str] = None):
    """mel: [B, num_mels, T] -> waveform [B, 1, T * prod(rates)] (fp32).

    ``aa_impl`` (default ``cfg.aa_impl``) and ``layout`` (default
    ``cfg.layout``) choose the activations as the module docstring's table
    says; ``fused=True`` is the legacy alias of ``aa_impl="fused_pallas"``.
    """
    impl = aa_impl or ("fused_pallas" if fused else cfg.aa_impl)
    kind = layout or cfg.layout
    hybrid = kind == "nlc" and cfg.conv_impl == "pallas"
    cdt = getattr(torch, cfg.compute_dtype)
    x = mel.to(getattr(torch, cfg.carry_dtype))
    x = _conv_same(params["conv_pre"], x, cdt=cdt)
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i, rate in enumerate(cfg.upsample_rates):
        k = cfg.upsample_kernel_sizes[i]
        up = params["ups"][i]
        if hybrid and kind == "nlc" and up["weight"].shape[1] < NARROW:
            kind = "hybrid"
        y = conv_transpose1d_poly(x, up["weight"], up.get("bias"),
                                  stride=rate, compute_dtype=cdt)
        trim = (k - rate) // 2   # torch ConvTranspose1d padding
        if trim:
            y = y[..., trim:-trim]
        block = _stage_block(cfg, impl, kind, y.shape[1], cdt)
        acc = None
        for j, rb in enumerate(params["resblocks"][i]):
            out = block(rb, y, cfg.resblock_dilation_sizes[j])
            acc = out if acc is None else acc + out
        x = acc / num_kernels
    if kind == "nlc":
        x = _act_nlc(x, params["act_post"], cfg, impl)
    else:
        x = _act(x, params["act_post"], cfg,
                 "polyphase" if kind == "hybrid" or impl == "fused_conv"
                 else impl, fast=kind == "hybrid" and impl == "fused_conv")
    x = _conv_same(params["conv_post"], x, cdt=cdt)
    return torch.clamp(x.float(), -1.0, 1.0)


def import_bigvgan_state_dict(sd: Dict[str, np.ndarray],
                              cfg: VocoderConfig) -> Dict:
    """A BigVGAN generator state dict (numpy arrays or CPU tensors; weight
    norm folded where it is not already) as the param tree of CPU tensors;
    the activations' ``alpha`` / ``beta`` [1, C, 1] become [C]."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def conv(prefix):
        out = {"weight": t(_fold_weight_norm(sd, prefix))}
        if f"{prefix}.bias" in sd:
            out["bias"] = t(sd[f"{prefix}.bias"])
        return out

    def act(prefix):
        out = {"alpha": t(np.asarray(sd[f"{prefix}.alpha"]).reshape(-1))}
        if f"{prefix}.beta" in sd:
            out["beta"] = t(np.asarray(sd[f"{prefix}.beta"]).reshape(-1))
        return out

    nk = len(cfg.resblock_kernel_sizes)
    resblocks = []
    for i in range(len(cfg.upsample_rates)):
        level = []
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            b = f"resblocks.{i * nk + j}"
            nd = range(len(dils))
            level.append({
                "convs1": [conv(f"{b}.convs1.{m}") for m in nd],
                "convs2": [conv(f"{b}.convs2.{m}") for m in nd],
                "act1": [act(f"{b}.activations.{2 * m}.act") for m in nd],
                "act2": [act(f"{b}.activations.{2 * m + 1}.act")
                         for m in nd],
            })
        resblocks.append(level)
    return {"conv_pre": conv("conv_pre"),
            "ups": [conv(f"ups.{i}.0")
                    for i in range(len(cfg.upsample_rates))],
            "resblocks": resblocks,
            "act_post": act("activation_post.act"),
            "conv_post": conv("conv_post")}


def export_bigvgan_state_dict(tree: Dict, cfg: VocoderConfig) -> Dict:
    """The vocoder tree under BigVGAN's generator names, as CPU tensors:
    the inverse of ``import_bigvgan_state_dict`` (weights already folded,
    ``alpha`` / ``beta`` kept [C])."""
    sd = {}

    def put(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{k}"] = v.detach().cpu()

    put("conv_pre", tree["conv_pre"])
    nk = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(tree["ups"]):
        put(f"ups.{i}.0", up)
        for j, rb in enumerate(tree["resblocks"][i]):
            b = f"resblocks.{i * nk + j}"
            for m in range(len(rb["convs1"])):
                put(f"{b}.convs1.{m}", rb["convs1"][m])
                put(f"{b}.convs2.{m}", rb["convs2"][m])
                put(f"{b}.activations.{2 * m}.act", rb["act1"][m])
                put(f"{b}.activations.{2 * m + 1}.act", rb["act2"][m])
    put("activation_post.act", tree["act_post"])
    put("conv_post", tree["conv_post"])
    return sd
