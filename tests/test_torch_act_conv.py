"""The port's fused anti-aliased SnakeBeta -> conv (plain version, which
kernel C is held to on the card) against the Pallas aa_snake_conv1d in
interpret mode, over the WHOLE tensor, edges included: the port repeats
the Pallas kernel's edge semantics (replicate-padded x, activation zeroed
outside [0, T)), so there is no loose edge band.

Tolerances: fp32 5e-4 absolute and relative; bf16 operands 6e-2 (the
activation is rounded to bf16 before the taps in both)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ditto_tts_tpu.ops.act_conv_pallas import aa_snake_conv1d as jfused
from ditto_tts_tpu.ops import snake as jsnake

from ditto_tts_tpu_torch.ops import snake as tsnake
from ditto_tts_tpu_torch.ops.act_conv import aa_snake_conv1d

from _torch_port_util import assert_close, jx, tt


def _case(b, t, c, o, k, seed, beta=True, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)      # JAX [B,T,C]
    alpha = (0.3 * rng.standard_normal(c)).astype(np.float32)
    be = (0.3 * rng.standard_normal(c)).astype(np.float32) if beta else None
    w = (0.2 * rng.standard_normal((o, c, k))).astype(np.float32)
    bv = rng.standard_normal(o).astype(np.float32) if bias else None
    return x, alpha, be, w, bv


def _both(x, alpha, be, w, bv, dil, logscale=True, **kw):
    want = jfused(jx(x), jx(alpha), None if be is None else jx(be), jx(w),
                  None if bv is None else jx(bv), dilation=dil,
                  logscale=logscale, interpret=True, **kw)
    got = aa_snake_conv1d(tt(x.transpose(0, 2, 1)), tt(alpha),
                          None if be is None else tt(be), tt(w),
                          None if bv is None else tt(bv), dilation=dil,
                          logscale=logscale)
    return got, want


@pytest.mark.parametrize("shape,k,dil", [((1, 300, 8), 3, 1),
                                         ((2, 520, 16), 7, 3),
                                         ((1, 290, 12), 11, 5)])
def test_fused_act_conv_whole_tensor(shape, k, dil):
    b, t, c = shape
    x, alpha, be, w, bv = _case(b, t, c, c, k, seed=0)
    got, want = _both(x, alpha, be, w, bv, dil, block_t=256)
    assert got.shape == (b, c, t)
    assert_close(got.transpose(1, 2), want, rtol=5e-4, atol=5e-4)


def test_fused_act_conv_wide_out_plain_snake_no_bias():
    x, alpha, _, w, _ = _case(1, 400, 16, 64, 7, seed=1, beta=False,
                              bias=False)
    got, want = _both(x, alpha, None, w, None, 1, block_t=128)
    assert_close(got.transpose(1, 2), want, rtol=5e-4, atol=5e-4)


def test_fused_act_conv_linear_scale():
    x, alpha, be, w, bv = _case(1, 200, 8, 8, 3, seed=2)
    got, want = _both(x, np.abs(alpha) + 0.5, np.abs(be) + 0.5, w, bv, 1,
                      logscale=False)
    assert_close(got.transpose(1, 2), want, rtol=5e-4, atol=5e-4)


def test_fused_act_conv_bf16():
    x, alpha, be, w, bv = _case(1, 300, 8, 8, 7, seed=3)
    want = jfused(jx(x).astype(jnp.bfloat16), jx(alpha), jx(be), jx(w),
                  jx(bv), dilation=3, compute_dtype=jnp.bfloat16,
                  interpret=True)
    got = aa_snake_conv1d(tt(x.transpose(0, 2, 1)).bfloat16(), tt(alpha),
                          tt(be), tt(w), tt(bv), dilation=3,
                          compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_close(got.transpose(1, 2), want, rtol=6e-2, atol=6e-2)


def test_short_sequence_takes_the_unfused_form():
    """T below the Pallas kernel's halo: both wrappers run the polyphase
    activation + conv, exactly."""
    x, alpha, be, w, bv = _case(1, 48, 8, 8, 11, seed=4)
    got, want = _both(x, alpha, be, w, bv, 5)
    assert_close(got.transpose(1, 2), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beta", [True, False])
def test_polyphase_activation_matches_jax(beta):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 90)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(6)).astype(np.float32)
    be = (0.3 * rng.standard_normal(6)).astype(np.float32)

    def jfn(v):
        if beta:
            return jsnake.snake_beta(v, jx(alpha), jx(be))
        return jsnake.snake(v, jx(alpha))

    def tfn(v):
        return tsnake.snake_beta(v, tt(alpha), tt(be) if beta else None)

    want = jsnake.polyphase_anti_aliased_activation(jx(x), jfn)
    got = tsnake.polyphase_anti_aliased_activation(tt(x), tfn)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    # and the composed up -> act -> down oracle
    want2 = jsnake.anti_aliased_activation(jx(x), jfn)
    assert_close(got, want2, rtol=1e-4, atol=1e-4)
