"""The port's fused anti-aliased SnakeBeta -> conv (plain version, which
kernel C is held to on the card) against the Pallas aa_snake_conv1d and
its time-minor twin aa_snake_conv1d_ncl (with the residual epilogue) in
interpret mode, over the WHOLE tensor, edges included: the port repeats
the Pallas kernels' edge semantics (replicate-padded x, activation zeroed
outside [0, T)), so there is no loose edge band.

Tolerances: fp32 5e-4 absolute and relative; bf16 operands 6e-2 (the
activation is rounded to bf16 before the taps in both)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ditto_tts_tpu.ops.act_conv_pallas import aa_snake_conv1d as jfused
from ditto_tts_tpu.ops.act_conv_pallas import aa_snake_conv1d_ncl as jfused_ncl
from ditto_tts_tpu.ops import snake as jsnake

import torch.nn.functional as F

from ditto_tts_tpu_torch.ops import snake as tsnake
from ditto_tts_tpu_torch.ops.act_conv import aa_snake_conv1d, \
    aa_snake_conv1d_ncl, aa_snake_conv1d_plain
from ditto_tts_tpu_torch.ops.conv import conv1d_plain
from ditto_tts_tpu_torch.ops.snake_fused import fused_snake_plain

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


def _both_ncl(x, alpha, be, w, bv, dil, res, bf16=False, **kw):
    """x [B, C, T] numpy; ``bf16``: bf16 operands, fp32 carry."""
    def opt(v, f):
        return None if v is None else f(v)

    want = jfused_ncl(jx(x), jx(alpha), opt(be, jx), jx(w), opt(bv, jx),
                      dilation=dil, residual=opt(res, jx), interpret=True,
                      compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    got = aa_snake_conv1d_ncl(tt(x), tt(alpha), opt(be, tt), tt(w),
                              opt(bv, tt), dilation=dil,
                              residual=opt(res, tt),
                              compute_dtype=torch.bfloat16 if bf16 else None)
    return got, want


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("beta", [True, False])
@pytest.mark.parametrize("shape,k,dil", [((1, 8, 300), 3, 1),
                                         ((2, 16, 600), 11, 5),
                                         ((1, 24, 130), 7, 3)])
def test_fused_act_conv_ncl_whole_tensor(shape, k, dil, beta, residual):
    b, c, t = shape
    x, alpha, be, w, bv = _case(b, t, c, c, k, seed=10, beta=beta)
    res = np.random.default_rng(11).standard_normal(
        (b, c, t)).astype(np.float32) if residual else None
    got, want = _both_ncl(x.transpose(0, 2, 1).copy(), alpha, be, w, bv,
                          dil, res, block_t=256)
    assert got.shape == (b, c, t)
    assert_close(got, want, rtol=5e-4, atol=5e-4)


def test_fused_act_conv_ncl_bf16_compute_fp32_residual():
    """fp32 carry, bf16 operands: the residual joins the fp32 sum, and the
    output is rounded once, to fp32."""
    x, alpha, be, w, bv = _case(2, 400, 8, 8, 7, seed=12)
    res = np.random.default_rng(13).standard_normal(
        (2, 8, 400)).astype(np.float32)
    got, want = _both_ncl(x.transpose(0, 2, 1).copy(), alpha, be, w, bv, 3,
                          res, bf16=True)
    assert got.dtype == torch.float32
    # a second rounding through bf16 would show at ~1e-2
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ncl_short_sequence_takes_the_unfused_form():
    """T below the time-minor kernel's 128-rounded halo (K=11, dil=12):
    both wrappers run polyphase + conv and add the residual after it."""
    x, alpha, be, w, bv = _case(1, 100, 8, 8, 11, seed=14)
    res = np.random.default_rng(15).standard_normal(
        (1, 8, 100)).astype(np.float32)
    got, want = _both_ncl(x.transpose(0, 2, 1).copy(), alpha, be, w, bv, 12,
                          res)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beta", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_its_two_pass_composition(dtype, beta):
    """Kernel C's function is kernel D's #9 function (fp32 upsample taps,
    the result in x's type, which is C's rounding of the activation),
    zero-padded by the conv's 'SAME' halo, then the VALID conv: the two-pass
    composition that is C's yardstick on the card (``kernel_bench.py``).
    fp32 1e-5 absolute (the two sum the activation in other orders); bf16
    1e-2 of max |y| (an order difference can flip a bf16 rounding of z)."""
    rng = np.random.default_rng(20)
    c, t, k, dil = 96, 300, 11, 5
    x = tt(2.0 * rng.standard_normal((2, c, t)).astype(np.float32)).to(dtype)
    alpha = tt((0.3 * rng.standard_normal(c)).astype(np.float32))
    be = tt((0.3 * rng.standard_normal(c)).astype(np.float32)) if beta \
        else None
    a, inv_b = tsnake.snake_coeffs(alpha, be)
    w = tt(((c * k) ** -0.5 * rng.standard_normal((c, c, k))).astype(
        np.float32)).to(dtype)
    bias = tt(rng.standard_normal(c).astype(np.float32))
    got = aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil)
    ca = (k - 1) * dil // 2
    z = fused_snake_plain(x, a, inv_b, up_in_x_dtype=False)
    want = conv1d_plain(F.pad(z, (ca, ca)), w, bias, dilation=dil)
    assert got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bf16", [False, True])
def test_composed_and_gemm_activations_match_jax(bf16):
    """The composed oracle and the banded-GEMM polyphase carry x's type
    between their steps, as the JAX forms do (fp32 1e-5; bf16 2e-2, a few
    bf16 ulps at |y| <= 4)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 300)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(6)).astype(np.float32)
    be = (0.3 * rng.standard_normal(6)).astype(np.float32)
    xj = jx(x).astype(jnp.bfloat16) if bf16 else jx(x)
    xt = tt(x).bfloat16() if bf16 else tt(x)
    tol = 2e-2 if bf16 else 1e-5

    def jfn(axis):
        return lambda v: jsnake.snake_beta(v, jx(alpha), jx(be),
                                           channel_axis=axis)

    def tfn(v):
        return tsnake.snake_beta(v, tt(alpha), tt(be))

    got = tsnake.anti_aliased_activation(xt, tfn)
    assert got.dtype == xt.dtype
    assert_close(got, jsnake.anti_aliased_activation(xj, jfn(1)), rtol=tol,
                 atol=tol)
    got = tsnake.polyphase_anti_aliased_activation_gemm(xt, tfn)
    assert got.dtype == xt.dtype
    want = jsnake.polyphase_anti_aliased_activation_gemm(
        xj.transpose(0, 2, 1), jfn(1)).transpose(0, 2, 1)
    assert_close(got, want, rtol=tol, atol=tol)
