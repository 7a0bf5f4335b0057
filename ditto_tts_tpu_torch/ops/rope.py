"""Rotary position embeddings (the JAX package's ``ops/rope.py``).

  inv_freq_j = 1 / 10000^(2j/d),   j in [0, d/2)
  pos[i]     = concat(i*inv_freq, i*inv_freq)          # [seq, d]
  rope(t)    = t * cos(pos) + rotate_half(t) * sin(pos)
  rotate_half([x1, x2]) = [-x2, x1]                    # half-split
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
