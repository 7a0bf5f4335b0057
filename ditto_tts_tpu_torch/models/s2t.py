"""Speech2Text ASR (an s2t-medium encoder-decoder), the JAX package's
``models/s2t.py``, for CER/WER evaluation (ref src/model/Speech2Text.py:5-21,
a frozen HF ``facebook/s2t-medium-mustc-multilingual-st`` with a forced
French BOS):

  fbank [B, T, 80] -> two stride-2 convs with GLU -> x sqrt(d_model) +
  sinusoidal positions -> pre-norm encoder (final LN); decoder: scaled token
  embeddings + positions -> pre-norm layers with cross-attention -> final
  LN -> the tied LM head.

Positions follow fairseq: a cumsum over the valid slots plus the padding
index, pad slots on the zero row. Attention is JAX's fp32 matmul-softmax
with additive -1e9 biases (``ops.attention.attention_plain``; JAX computes
it outside Pallas, so it never reaches kernel A). The convs are
``F.conv1d``: on the card cuDNN may run fp32 convs in TF32 unless the
caller turns ``torch.backends.cudnn.allow_tf32`` off.

``greedy_decode`` keeps JAX's fixed-length semantics: ids start
``<start> <lang>``, every step recomputes the whole decoder over all
``max_len`` slots (no KV cache) and takes the argmax at the step, and a
row that has emitted EOS writes pad from then on. ``log_mel_fbank`` is the
kaldi-style 80-band fbank on the host in float64, as JAX's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.core import dense, layer_norm
from ..ops.attention import attention_plain


@dataclasses.dataclass(frozen=True)
class S2TConfig:
    vocab_size: int = 10000
    d_model: int = 256
    encoder_layers: int = 12
    decoder_layers: int = 6
    encoder_heads: int = 4
    decoder_heads: int = 4
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    num_conv_layers: int = 2
    conv_channels: int = 1024
    conv_kernel: int = 5
    input_features: int = 80
    pad_token_id: int = 1
    eos_token_id: int = 2
    max_positions: int = 6000


def s2t_medium_config() -> S2TConfig:
    return S2TConfig(d_model=512, encoder_heads=8, decoder_heads=8,
                     vocab_size=10000)


# ---------------------------------------------------------------------------
# sinusoidal positions (fairseq convention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _sinusoid_table(num: int, dim: int, padding_idx: int) -> np.ndarray:
    """[num, dim] fp32 (cached: greedy decoding asks for the same table at
    every step; callers copy it)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000.0) / (half - 1)))
    pos = np.arange(num, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num, 1))], axis=1)
    emb[padding_idx] = 0.0
    return emb.astype(np.float32)


def _positions_from_mask(mask, padding_idx: int):
    """fairseq position ids: cumsum over valid slots + padding_idx."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, dim=1) * m + padding_idx


def _pos_embed(cfg: S2TConfig, mask):
    seq = mask.shape[1]
    table = torch.tensor(_sinusoid_table(
        seq + cfg.pad_token_id + 2, cfg.d_model, cfg.pad_token_id),
        device=mask.device)
    return table[_positions_from_mask(mask, cfg.pad_token_id)]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _mha(p, q_in, kv_in, heads: int, bias=None):
    d = q_in.shape[-1]
    hd = d // heads
    q = dense(p["q_proj"], q_in) * (hd ** -0.5)
    k = dense(p["k_proj"], kv_in)
    v = dense(p["v_proj"], kv_in)

    def split(x):
        b, s, _ = x.shape
        return x.reshape(b, s, heads, hd).transpose(1, 2)

    out = attention_plain(split(q), split(k), split(v), sm_scale=1.0,
                          bias=bias)
    b, _, s, _ = out.shape
    return dense(p["out_proj"], out.transpose(1, 2).reshape(b, s, d))


def _pad_bias(mask):
    return (1.0 - mask.float())[:, None, None, :] * -1e9


def _causal_bias(s: int, device):
    return torch.full((s, s), -1e9, device=device).triu(1)[None, None]


def subsample(params, cfg: S2TConfig, features, mask):
    """features: [B, T, 80] -> [B, ceil(T/4), d_model]; mask downsampled."""
    h = features.transpose(1, 2)                 # [B, 80, T]
    for conv in params["conv_layers"]:
        pad = conv["weight"].shape[-1] // 2
        h = F.conv1d(F.pad(h, (pad, pad)), conv["weight"], stride=2)
        h = h + conv["bias"][None, :, None]
        a, b = h.chunk(2, dim=1)
        h = a * torch.sigmoid(b)                 # GLU over channels
        mask = mask[:, ::2][:, :h.shape[-1]]
    return h.transpose(1, 2), mask


def encode(params, cfg: S2TConfig, features, mask):
    h, mask = subsample(params["conv"], cfg, features, mask)
    h = h * math.sqrt(cfg.d_model) + _pos_embed(cfg, mask)
    bias = _pad_bias(mask)
    for lyr in params["encoder_layers"]:
        x = layer_norm(lyr["self_attn_layer_norm"], h)
        h = h + _mha(lyr["self_attn"], x, x, cfg.encoder_heads, bias)
        x = layer_norm(lyr["final_layer_norm"], h)
        h = h + dense(lyr["fc2"], torch.relu(dense(lyr["fc1"], x)))
    return layer_norm(params["encoder_norm"], h), mask


def decode_logits(params, cfg: S2TConfig, token_ids, enc_out, enc_mask):
    tok_mask = token_ids != cfg.pad_token_id
    h = params["embed_tokens"]["weight"][token_ids]
    h = h * math.sqrt(cfg.d_model) + _pos_embed(cfg, tok_mask)
    self_bias = _causal_bias(token_ids.shape[1], h.device) \
        + _pad_bias(tok_mask)
    cross_bias = _pad_bias(enc_mask)
    for lyr in params["decoder_layers"]:
        x = layer_norm(lyr["self_attn_layer_norm"], h)
        h = h + _mha(lyr["self_attn"], x, x, cfg.decoder_heads, self_bias)
        x = layer_norm(lyr["encoder_attn_layer_norm"], h)
        h = h + _mha(lyr["encoder_attn"], x, enc_out, cfg.decoder_heads,
                     cross_bias)
        x = layer_norm(lyr["final_layer_norm"], h)
        h = h + dense(lyr["fc2"], torch.relu(dense(lyr["fc1"], x)))
    h = layer_norm(params["decoder_norm"], h)
    return torch.matmul(h.float(),
                        params["embed_tokens"]["weight"].float().t())


@torch.inference_mode()
def greedy_decode(params, cfg: S2TConfig, features, mask, *,
                  forced_bos_id: int, max_len: int = 128,
                  decoder_start_id: Optional[int] = None):
    """Fixed-length greedy generation: [B, max_len] int64 ids laid out
    ``<start> <lang> tokens... </s>``, pad after EOS. Runs
    ``encoder_layers + (max_len - 2) * decoder_layers * 2`` attention
    calls."""
    start = cfg.eos_token_id if decoder_start_id is None else decoder_start_id
    enc_out, enc_mask = encode(params, cfg, features, mask)
    b = features.shape[0]
    ids = torch.full((b, max_len), cfg.pad_token_id, dtype=torch.int64,
                     device=features.device)
    ids[:, 0] = start
    ids[:, 1] = forced_bos_id
    done = torch.zeros((b,), dtype=torch.bool, device=features.device)
    for i in range(2, max_len):
        logits = decode_logits(params, cfg, ids, enc_out, enc_mask)
        nxt = torch.argmax(logits[:, i - 1], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        ids[:, i] = nxt
        done = done | (nxt == cfg.eos_token_id)
    return ids


def greedy_compared_steps(want_ids, ref_logits, tol: float, eos: int) -> int:
    """How far two greedy decodes can be held to each other: the first
    step i at which a row not yet done has a reference top-2 logit margin
    (at position i - 1) below 10 x ``tol``, the logits' tolerance, else the
    full length. ``want_ids`` [B, L] is the reference decode and
    ``ref_logits`` [B, L, V] its ``decode_logits``; ids are compared before
    the returned step, since a near-tie may flip between devices."""
    top = ref_logits.topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    for i in range(2, want_ids.shape[1]):
        done = (want_ids[:, 2:i] == eos).any(dim=1)
        if ((margin[:, i - 1] < 10 * tol) & ~done).any():
            return i
    return want_ids.shape[1]


# ---------------------------------------------------------------------------
# kaldi-style fbank features (HF Speech2TextFeatureExtractor equivalent)
# ---------------------------------------------------------------------------

def log_mel_fbank(wav: np.ndarray, sample_rate: int = 16000, *,
                  num_mels: int = 80, frame_ms: float = 25.0,
                  shift_ms: float = 10.0, cmvn: bool = True) -> np.ndarray:
    """[T] float waveform -> [frames, num_mels] log-mel fbank with
    per-utterance mean/var normalization (kaldi povey window, snip edges)."""
    wav = np.asarray(wav, np.float64) * 32768.0   # kaldi int16 scaling
    frame = int(sample_rate * frame_ms / 1000)
    shift = int(sample_rate * shift_ms / 1000)
    n_fft = 1 << (frame - 1).bit_length()
    n = 1 + (len(wav) - frame) // shift
    if n <= 0:
        return np.zeros((0, num_mels), np.float32)
    idx = np.arange(n)[:, None] * shift + np.arange(frame)[None, :]
    frames = wav[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)  # remove DC
    frames = np.concatenate(
        [frames[:, :1], frames[:, 1:] - 0.97 * frames[:, :-1]], axis=1)
    window = (0.5 - 0.5 * np.cos(
        2 * np.pi * np.arange(frame) / (frame - 1))) ** 0.85  # povey
    spec = np.abs(np.fft.rfft(frames * window, n_fft)) ** 2

    # mel filterbank on the kaldi (HTK) mel scale
    def hz2mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)

    low, high = hz2mel(20.0), hz2mel(sample_rate / 2.0)
    pts = mel2hz(np.linspace(low, high, num_mels + 2))
    bins = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((num_mels, len(bins)))
    for m in range(num_mels):
        left, center, right = pts[m], pts[m + 1], pts[m + 2]
        up = (bins - left) / (center - left)
        down = (right - bins) / (right - center)
        fb[m] = np.maximum(0, np.minimum(up, down))
    mel = spec @ fb.T
    logmel = np.log(np.maximum(mel, 1e-10))
    if cmvn:
        logmel = (logmel - logmel.mean(axis=0, keepdims=True)) \
            / (logmel.std(axis=0, keepdims=True) + 1e-8)
    return logmel.astype(np.float32)


# ---------------------------------------------------------------------------
# HF import
# ---------------------------------------------------------------------------

def import_hf_state_dict(sd: Dict[str, np.ndarray], cfg: S2TConfig) -> Dict:
    """An HF Speech2TextForConditionalGeneration (or Speech2TextModel)
    state dict as the param tree of CPU tensors."""
    p = "model." if any(k.startswith("model.") for k in sd) else ""

    def arr(n):
        return torch.from_numpy(np.array(sd[n], copy=True))

    def lin(prefix):
        out = {"weight": arr(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            out["bias"] = arr(f"{prefix}.bias")
        return out

    def attn(prefix):
        return {k: lin(f"{prefix}.{k}")
                for k in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def layer(b, cross: bool):
        out = {"self_attn": attn(f"{b}.self_attn"),
               "self_attn_layer_norm": lin(f"{b}.self_attn_layer_norm"),
               "fc1": lin(f"{b}.fc1"), "fc2": lin(f"{b}.fc2"),
               "final_layer_norm": lin(f"{b}.final_layer_norm")}
        if cross:
            out["encoder_attn"] = attn(f"{b}.encoder_attn")
            out["encoder_attn_layer_norm"] = lin(
                f"{b}.encoder_attn_layer_norm")
        return out

    return {
        "conv": {"conv_layers": [lin(f"{p}encoder.conv.conv_layers.{i}")
                                 for i in range(cfg.num_conv_layers)]},
        "encoder_layers": [layer(f"{p}encoder.layers.{i}", False)
                           for i in range(cfg.encoder_layers)],
        "encoder_norm": lin(f"{p}encoder.layer_norm"),
        "embed_tokens": lin(f"{p}decoder.embed_tokens"),
        "decoder_layers": [layer(f"{p}decoder.layers.{i}", True)
                           for i in range(cfg.decoder_layers)],
        "decoder_norm": lin(f"{p}decoder.layer_norm"),
    }
