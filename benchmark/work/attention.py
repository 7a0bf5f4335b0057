"""Operations and bytes of one softmax-attention call, from its shapes:
softmax(Q K^T / sqrt(d)) V over [B, H, Sq, D] queries and [B, H, Sk, D]
keys and values. Two products of 2 Sq Sk D operations a head; Q, K and V
read once and the output written once."""

from .peaks import BYTES


def call(b: int, h: int, sq: int, sk: int, d: int, dtype: str):
    """(flops, bytes) of one attention call."""
    flops = 4.0 * b * h * sq * sk * d
    nbytes = BYTES[dtype] * b * h * d * (2 * sq + 2 * sk)
    return flops, nbytes
