"""The port's attention (plain version, which kernel A is held to on the
card) against the Pallas kernels pallas_attention and
pallas_attention_packed in interpret mode, and sdpa_reference.

Tolerances: fp32 1e-5 (the same math summed in another order); bf16 2e-2
(the operands are bf16, so results agree to a few bf16 ulps)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ditto_tts_tpu.ops.attention import (pallas_attention,
                                         pallas_attention_packed,
                                         sdpa_reference)

from ditto_tts_tpu_torch.ops.attention import attention, attention_plain

from _torch_port_util import assert_close, jx, tt


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 4, 40, 40, 64),     # DiT self-attention shape class (packed heads)
    (1, 2, 37, 12, 64),     # cross-attention to a short text
    (1, 2, 24, 50, 128),    # D=128: one head per lane block
])
def test_attention_matches_pallas_packed(b, h, sq, sk, d):
    q, k, v = _qkv(b, h, sq, sk, d)
    want = pallas_attention_packed(jx(q), jx(k), jx(v), block_q=16,
                                   interpret=True)
    got = attention(tt(q), tt(k), tt(v))
    assert got.shape == (b, h, sq, d)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_pallas_unpacked(causal):
    q, k, v = _qkv(2, 3, 33, 33, 64, seed=1)
    want = pallas_attention(jx(q), jx(k), jx(v), causal=causal, block_q=16,
                            interpret=True)
    got = attention(tt(q), tt(k), tt(v), causal=causal)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_kv_length_padding():
    """Keys padded past kv_len are masked: the padded call equals the
    Pallas kernel (which pads to 128 and masks itself) on the unpadded
    keys."""
    q, k, v = _qkv(1, 2, 20, 21, 64, seed=2)
    want = pallas_attention_packed(jx(q), jx(k), jx(v), block_q=8,
                                   interpret=True)
    pad = ((0, 0), (0, 0), (0, 11), (0, 0))
    kp = np.pad(k, pad, constant_values=7.0)
    vp = np.pad(v, pad, constant_values=-3.0)
    got = attention(tt(q), tt(kp), tt(vp), kv_len=21)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_sm_scale_and_strided_inputs():
    """Explicit scale, and q/k/v as transposed views of [B, S, H, D] (the
    DiT's layout) give the same result as contiguous inputs."""
    q, k, v = _qkv(2, 4, 16, 16, 64, seed=3)
    want = sdpa_reference(jx(q), jx(k), jx(v), sm_scale=0.3)
    qs, ks, vs = (tt(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
                  .transpose(1, 2) for a in (q, k, v))
    assert not qs.is_contiguous()
    got = attention(qs, ks, vs, sm_scale=0.3)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_bf16_matches_pallas_bf16():
    q, k, v = _qkv(1, 4, 30, 30, 64, seed=4)
    want = pallas_attention_packed(jx(q).astype(jnp.bfloat16),
                                   jx(k).astype(jnp.bfloat16),
                                   jx(v).astype(jnp.bfloat16), block_q=16,
                                   interpret=True)
    got = attention_plain(tt(q).bfloat16(), tt(k).bfloat16(),
                          tt(v).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_close(got, want, rtol=2e-2, atol=2e-2)
