"""The port's standalone fused anti-aliased Snake (plain versions, which
kernel D is held to on the card) against the Pallas fused_snake_pallas
([B, C, T]) and fused_snake_nlc ([B, T, C]) in interpret mode, over the
whole tensor, edges included: the port repeats each kernel's edge
semantics (x replicate-padded by 8 samples).

Tolerances: fp32 1e-5 absolute and relative (both sides take the Pallas
polynomial sin^2, ``ops.snake.sin2`` in the port, and differ in the order
of fp32 operations). bf16: at most one bf16 ulp on any element (relative
2^-7) and on no more than 1% of the elements: the two sides round at the
same places and differ only where an fp32 difference flips a rounding. A fused_snake computed the way fused_snake_nlc computes
(fp32 upsample taps) differs on a third to a half of the elements, by up
to two ulps; ``test_the_two_kernels_differ_in_bf16`` pins that.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ditto_tts_tpu.ops import snake as jsnake
from ditto_tts_tpu.ops.fastmath import sin2 as jsin2
from ditto_tts_tpu.ops.snake_pallas import fused_snake_pallas
from ditto_tts_tpu.ops.snake_pallas_nlc import fused_snake_nlc as jnlc

from ditto_tts_tpu_torch.ops.snake import sin2, snake_coeffs
from ditto_tts_tpu_torch.ops.snake_fused import (fused_snake,
                                                 fused_snake_nlc,
                                                 fused_snake_plain,
                                                 polyphase_snake)

from _torch_port_util import assert_close, jx, np_of, tt

SHAPES = [(2, 6, 300), (1, 3, 5), (1, 4, 2100), (2, 5, 130)]


@functools.lru_cache(maxsize=8)
def _case(b, c, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, alpha, beta


def _jax_both(x, alpha, beta, bf16, logscale=True):
    xj = jx(x).astype(jnp.bfloat16) if bf16 else jx(x)
    bj = None if beta is None else jx(beta)
    y8 = fused_snake_pallas(xj, jx(alpha), bj, logscale=logscale,
                            interpret=True)
    y9 = jnlc(xj.transpose(0, 2, 1), jx(alpha), bj, logscale=logscale,
              interpret=True)
    return np_of(y8), np_of(y9)


def _bf16_close(got, want):
    got, want = np_of(got), np_of(want)
    err = np.abs(got - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), err.max()
    assert (err > 0).mean() <= 0.01, (err > 0).mean()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_snake_matches_pallas(shape, with_beta, bf16):
    x, alpha, beta = _case(*shape)
    beta = beta if with_beta else None
    want8, want9 = _jax_both(x, alpha, beta, bf16)
    xt = tt(x).bfloat16() if bf16 else tt(x)
    bt = None if beta is None else tt(beta)
    got8 = fused_snake(xt, tt(alpha), bt)
    got9 = fused_snake_nlc(xt.transpose(1, 2).contiguous(), tt(alpha), bt)
    assert got8.dtype == got9.dtype == xt.dtype
    assert tuple(got8.shape) == shape and tuple(got9.shape) == want9.shape
    if bf16:
        _bf16_close(got8, want8)
        _bf16_close(got9, want9)
    else:
        assert_close(got8, want8, rtol=1e-5, atol=1e-5)
        assert_close(got9, want9, rtol=1e-5, atol=1e-5)


def test_linear_scale():
    x, alpha, beta = _case(1, 4, 200, seed=1)
    alpha, beta = np.abs(alpha) + 0.5, np.abs(beta) + 0.5
    want8, want9 = _jax_both(x, alpha, beta, False, logscale=False)
    assert_close(fused_snake(tt(x), tt(alpha), tt(beta), logscale=False),
                 want8, rtol=1e-5, atol=1e-5)
    assert_close(fused_snake_nlc(tt(x).transpose(1, 2), tt(alpha), tt(beta),
                                 logscale=False), want9, rtol=1e-5,
                 atol=1e-5)


def test_the_two_kernels_differ_in_bf16():
    """fused_snake_pallas's bf16 upsample taps are not fused_snake_nlc's
    fp32 ones: each plain version holds to its own kernel and misses the
    other's by more than the bf16 criterion allows."""
    x, alpha, beta = _case(2, 6, 300)
    want8, want9 = _jax_both(x, alpha, beta, True)
    want9 = want9.transpose(0, 2, 1)
    a, inv_b = snake_coeffs(tt(alpha), tt(beta))
    xt = tt(x).bfloat16()
    as_nlc = fused_snake_plain(xt, a, inv_b, up_in_x_dtype=False)
    as_ncl = fused_snake_plain(xt, a, inv_b, up_in_x_dtype=True)
    _bf16_close(as_ncl, want8)
    _bf16_close(as_nlc, want9)
    for got, want in ((as_nlc, want8), (as_ncl, want9)):
        with pytest.raises(AssertionError):
            _bf16_close(got, want)


def test_sin2_matches_the_jax_fastmath_polynomial():
    """The port's copy of the Pallas kernels' pi-periodic sin^2 (kernels C
    and D and their plain versions take it) against the JAX
    ``ops/fastmath.py:sin2``, to 1e-6 absolute over |x| <= 1e3, the
    multiples of pi/2 (where the reduction switches n) included; and
    within 1e-6 of sin(x)^2 in float64."""
    rng = np.random.default_rng(3)
    k = np.arange(-636, 637)
    x = np.concatenate([rng.uniform(-1e3, 1e3, 20000),
                        k * np.pi / 2, k * np.pi / 2 + 1e-4,
                        k * np.pi / 2 - 1e-4, [0.0, 1e3, -1e3]])
    x = x.astype(np.float32)
    got = sin2(torch.from_numpy(x)).numpy()
    want = np.asarray(jsin2(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - np.sin(x.astype(np.float64)) ** 2).max() <= 1e-6


def _jax_polyphase(x, alpha, beta, fast):
    """The JAX polyphase form with the JAX SnakeBeta (plain Snake: beta =
    alpha, as ``snake_coeffs`` takes it), on fp32 x."""
    bj = jx(alpha if beta is None else beta)
    return np_of(jsnake.polyphase_anti_aliased_activation(
        jx(x), lambda v: jsnake.snake_beta(v, jx(alpha), bj, fast=fast)))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("t", [1, 2, 3, 7, 40])
def test_polyphase_snake_on_cpu_is_the_jax_polyphase_form(t, with_beta,
                                                          fast):
    """``polyphase_snake`` on a CPU tensor (the plain form kernel D's
    polyphase mode is held to on the card) against the JAX
    ``polyphase_anti_aliased_activation`` with ``snake_beta(fast=...)``,
    T shorter than the edges' reach included."""
    x, alpha, beta = _case(2, 3, t, seed=4)
    beta = beta if with_beta else None
    got = polyphase_snake(tt(x), tt(alpha), None if beta is None
                          else tt(beta), fast=fast)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, t)
    assert_close(got, _jax_polyphase(x, alpha, beta, fast), rtol=1e-5,
                 atol=1e-5)


@pytest.mark.parametrize("fast", [True, False])
def test_polyphase_snake_on_cpu_in_bf16(fast):
    """A bf16 x runs in fp32 and returns bf16: the JAX form on the same
    values, rounded once."""
    x, alpha, beta = _case(2, 6, 300)
    xb = tt(x).bfloat16()
    got = polyphase_snake(xb, tt(alpha), tt(beta), fast=fast)
    assert got.dtype == torch.bfloat16
    want = tt(_jax_polyphase(np_of(xb), alpha, beta, fast)).bfloat16()
    _bf16_close(got, want)

