"""Rotary position embeddings (the JAX package's ``ops/rope.py``).

  inv_freq_j = 1 / 10000^(2j/d),   j in [0, d/2)
  pos[i]     = concat(i*inv_freq, i*inv_freq)          # [seq, d]
  rope(t)    = t * cos(pos) + rotate_half(t) * sin(pos)
  rotate_half([x1, x2]) = [-x2, x1]                    # half-split

The interleaved form (x-transformers' ``RotaryEmbedding``, which F5-TTS
uses) pairs neighbouring channels instead of the two halves: the angles
repeat pairwise, pos[i] = (i f_0, i f_0, i f_1, i f_1, ...), and
rotate_pairs maps each pair (x_2j, x_2j+1) to (-x_2j+1, x_2j). It is
computed as such on the weights as they are, not by permuting q and k.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _freq_table_np(seq_len: int, dim: int):
    j = np.arange(0, dim, 2, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (j / dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                    # [seq, dim/2]
    pos = np.concatenate([freqs, freqs], axis=-1)    # [seq, dim]
    return np.cos(pos), np.sin(pos)


def rope_tables(seq_len: int, dim: int, *, dtype=torch.float32,
                device=None):
    """(cos, sin) tables of shape [seq_len, dim]."""
    cos, sin = _freq_table_np(seq_len, dim)
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """x: [batch, seq, heads, head_dim] or [..., seq, head_dim]; cos/sin:
    [seq, head_dim], broadcast over the batch and head axes."""
    if x.dim() == 4:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _pair_table_np(seq_len: int, dim: int):
    j = np.arange(0, dim, 2, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (j / dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float32), inv_freq)
    pos = np.repeat(freqs, 2, axis=-1)               # [seq, dim], pairwise
    return np.cos(pos), np.sin(pos)


def rope_tables_interleaved(seq_len: int, dim: int, *, dtype=torch.float32,
                            device=None):
    """(cos, sin) tables [seq_len, dim] of the interleaved form."""
    cos, sin = _pair_table_np(seq_len, dim)
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def rotate_pairs(x):
    """(x_2j, x_2j+1) -> (-x_2j+1, x_2j) along the last axis."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rope_interleaved(x, cos, sin):
    """As ``apply_rope``, with the interleaved tables and rotation."""
    if x.dim() == 4:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    return x * cos.to(x.dtype) + rotate_pairs(x) * sin.to(x.dtype)
