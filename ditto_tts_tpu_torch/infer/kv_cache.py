"""A static KV cache for autoregressive decoding: one bf16 (or fp32) buffer
[layers, 2, B, H, S_max, hd], zero-filled, whose per-layer K and V views
[B, H, S_max, hd] kernel A reads in place (their (b, h, s) strides are
multiples of 8 for any hd that is). ``write`` puts a prefill's keys and
values at positions 0..S-1; ``append`` puts one position a row at a
device-side index, so that a captured decode step appends wherever the
position tensor points at its replay."""

from __future__ import annotations

import torch


class KVCache:
    def __init__(self, layers: int, batch: int, heads: int, max_len: int,
                 head_dim: int, dtype, device):
        self.buf = torch.zeros((layers, 2, batch, heads, max_len, head_dim),
                               dtype=dtype, device=device)
        self.k = [self.buf[i, 0] for i in range(layers)]
        self.v = [self.buf[i, 1] for i in range(layers)]

    @property
    def nbytes(self) -> int:
        return self.buf.numel() * self.buf.element_size()

    def write(self, layer: int, k, v) -> None:
        """k, v [B, H, S, hd] into positions 0..S-1 of ``layer``."""
        s = k.shape[2]
        self.k[layer][:, :, :s].copy_(k)
        self.v[layer][:, :, :s].copy_(v)

    def append(self, layer: int, pos, k, v) -> None:
        """k, v [B, H, 1, hd] into position ``pos`` ([1] int64 on the
        device) of ``layer``."""
        self.k[layer].index_copy_(2, pos, k)
        self.v[layer].index_copy_(2, pos, v)
