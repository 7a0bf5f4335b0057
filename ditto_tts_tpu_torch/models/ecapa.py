"""ECAPA-TDNN speaker embedding (speechbrain's geometry), the JAX package's
``models/ecapa.py``, for SIM-o / SIM-r (ref src/Experiments.ipynb cell 14,
speechbrain's frozen ``spkrec-ecapa-voxceleb``):

  fbank [B, T, 80] -> TDNN conv (k5) -> 3 SE-Res2Net blocks (k3, dilations
  2/3/4, scale 8, SE 128) -> concat (3 x 512) -> conv 1536 -> attentive
  statistics pooling (128 attention channels, global context) -> BN ->
  linear to a 192-dim embedding.

BatchNorms run in inference mode (running statistics). The convs are
reflect-padded "same" ``F.conv1d`` calls, as JAX's reflect-padded
``lax.conv`` (not a Pallas kernel, so not kernel B); on the card cuDNN may
run them in TF32 unless the caller turns ``torch.backends.cudnn.allow_tf32``
off. ``import_speechbrain_state_dict`` maps speechbrain's
``embedding_model.*`` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ECAPAConfig:
    input_features: int = 80
    channels: int = 512
    out_channels: int = 1536
    embedding_dim: int = 192
    scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    kernel: int = 5
    res_kernel: int = 3
    dilations: tuple = (2, 3, 4)


def tiny_ecapa_config() -> ECAPAConfig:
    """A small geometry of the same architecture (CPU smoke and
    discrimination runs)."""
    return ECAPAConfig(channels=64, out_channels=128, embedding_dim=32,
                       se_channels=32, attention_channels=32, scale=4)


def _conv1d_same(x, p, *, dilation: int = 1):
    """x: [B, C, T]; torch-layout weight [O, I, K]; reflect "same" padding
    (speechbrain's Conv1d default)."""
    eff = (p["weight"].shape[-1] - 1) * dilation
    if eff:
        x = F.pad(x, (eff // 2, eff - eff // 2), mode="reflect")
    y = F.conv1d(x, p["weight"], dilation=dilation)
    if p.get("bias") is not None:
        y = y + p["bias"][None, :, None]
    return y


def _bn(p, x, eps: float = 1e-5):
    """Inference BatchNorm1d over the channel axis of [B, C, T] or [B, C]."""
    shape = (1, -1, 1) if x.ndim == 3 else (1, -1)
    y = (x - p["running_mean"].reshape(shape)) * torch.rsqrt(
        p["running_var"].reshape(shape) + eps)
    return y * p["weight"].reshape(shape) + p["bias"].reshape(shape)


def _tdnn(p, x, *, dilation: int = 1):
    return _bn(p["norm"], torch.relu(_conv1d_same(x, p["conv"],
                                                  dilation=dilation)))


def _res2net(p, cfg: ECAPAConfig, x, dilation: int):
    chunks = x.chunk(cfg.scale, dim=1)
    outs = [chunks[0]]
    prev = None
    for i in range(1, cfg.scale):
        inp = chunks[i] if prev is None else chunks[i] + prev
        prev = _tdnn(p["blocks"][i - 1], inp, dilation=dilation)
        outs.append(prev)
    return torch.cat(outs, dim=1)


def _se(p, x, mask=None):
    if mask is None:
        s = x.mean(dim=2, keepdim=True)
    else:
        m = mask[:, None, :].to(x.dtype)
        s = (x * m).sum(dim=2, keepdim=True) / m.sum(dim=2, keepdim=True)
    s = torch.relu(_conv1d_same(s, p["conv1"]))
    return x * torch.sigmoid(_conv1d_same(s, p["conv2"]))


def _se_res2net_block(p, cfg: ECAPAConfig, x, dilation: int, mask):
    y = _tdnn(p["tdnn1"], x)
    y = _res2net(p["res2net"], cfg, y, dilation)
    y = _tdnn(p["tdnn2"], y)
    return _se(p["se"], y, mask) + x


def _asp(p, x, mask=None):
    """Attentive statistics pooling with global context."""
    b, _, t = x.shape
    m = torch.ones((b, t), dtype=x.dtype, device=x.device) if mask is None \
        else mask.to(x.dtype)
    total = m.sum(dim=1, keepdim=True)

    def stats(v, w):
        mean = (v * w[:, None, :]).sum(dim=2) / total
        var = ((v - mean[..., None]) ** 2 * w[:, None, :]).sum(dim=2) / total
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))

    gmean, gstd = stats(x, m)
    ctx = torch.cat([x, gmean[..., None].expand_as(x),
                     gstd[..., None].expand_as(x)], dim=1)
    # the attention MLP is a whole TDNNBlock (conv -> ReLU -> BN), then
    # tanh (speechbrain AttentiveStatisticsPooling.tdnn), then the score conv
    a = torch.tanh(_bn(p["tdnn_norm"], torch.relu(_conv1d_same(
        ctx, p["tdnn_conv"]))))
    a = _conv1d_same(a, p["conv"])
    a = a.masked_fill(~(m[:, None, :] > 0), float("-inf"))
    w = torch.softmax(a, dim=2)
    mean = (x * w).sum(dim=2)
    # weighted E[(x - mean)^2], as speechbrain's _compute_statistics
    std = torch.sqrt(torch.clamp(((x - mean[..., None]) ** 2 * w).sum(dim=2),
                                 min=1e-12))
    return torch.cat([mean, std], dim=1)


def ecapa_embed(params, cfg: ECAPAConfig, features, mask=None):
    """features: [B, T, 80] fbank, mask [B, T] (1 = valid) or None ->
    [B, embedding_dim]."""
    x = _tdnn(params["block0"], features.transpose(1, 2))   # [B, C, T]
    outs = []
    for i, dil in enumerate(cfg.dilations):
        x = _se_res2net_block(params["blocks"][i], cfg, x, dil, mask)
        outs.append(x)
    # MFA is a whole TDNNBlock (conv -> ReLU -> BN), speechbrain's mfa
    x = _tdnn(params["mfa"], torch.cat(outs, dim=1))
    pooled = _bn(params["asp_norm"], _asp(params["asp"], x, mask)[..., None])
    return _conv1d_same(pooled, params["fc"])[..., 0]


def import_speechbrain_state_dict(sd: Dict[str, np.ndarray],
                                  cfg: ECAPAConfig) -> Dict:
    """A speechbrain ECAPA-TDNN ``embedding_model`` state dict as the param
    tree of CPU tensors: ``blocks.0`` the first TDNN, ``blocks.1-3`` the
    SE-Res2Net blocks, ``mfa``, ``asp``, ``asp_bn``, ``fc``; conv weights
    under ``.conv.weight`` [O, I, K], BatchNorms under ``.norm.norm.*``."""
    pre = "embedding_model." if any(
        k.startswith("embedding_model.") for k in sd) else ""

    def arr(n):
        return torch.from_numpy(np.array(sd[pre + n], copy=True))

    def conv(n):
        out = {"weight": arr(f"{n}.conv.weight")}
        if pre + f"{n}.conv.bias" in sd:
            out["bias"] = arr(f"{n}.conv.bias")
        return out

    def bn(n):
        return {k: arr(f"{n}.norm.{k}") for k in
                ("weight", "bias", "running_mean", "running_var")}

    def tdnn(n):
        return {"conv": conv(f"{n}.conv"), "norm": bn(f"{n}.norm")}

    blocks = []
    for b in range(1, 4):
        base = f"blocks.{b}"
        blocks.append({
            "tdnn1": tdnn(f"{base}.tdnn1"),
            "res2net": {"blocks": [tdnn(f"{base}.res2net_block.blocks.{i}")
                                   for i in range(cfg.scale - 1)]},
            "tdnn2": tdnn(f"{base}.tdnn2"),
            "se": {"conv1": conv(f"{base}.se_block.conv1"),
                   "conv2": conv(f"{base}.se_block.conv2")},
        })
    return {
        "block0": tdnn("blocks.0"),
        "blocks": blocks,
        "mfa": tdnn("mfa"),
        "asp": {"tdnn_conv": conv("asp.tdnn.conv"),
                "tdnn_norm": bn("asp.tdnn.norm"),
                "conv": conv("asp.conv")},
        "asp_norm": bn("asp_bn"),
        "fc": conv("fc"),
    }
