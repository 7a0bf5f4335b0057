"""The port's stride-1 conv (plain version, which kernel B is held to on
the card) against the Pallas conv1d_nlc_pallas and conv1d_ncl_pallas
(per-tap and windowed) in interpret mode, and the conv helpers of
nn/conv.py against their JAX counterparts.

Tolerances: fp32 2e-5 (another tap summation order); bf16 operands 2e-2
(results rounded to bf16 in both)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ditto_tts_tpu.nn import conv as jconv
from ditto_tts_tpu.ops.conv_pallas import conv1d_ncl_pallas, \
    conv1d_nlc_pallas

from ditto_tts_tpu_torch.nn import conv as tconv
from ditto_tts_tpu_torch.ops.conv import conv1d

from _torch_port_util import assert_close, jx, tt


def _case(b, c, t, o, k, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    w = (0.2 * rng.standard_normal((o, c, k))).astype(np.float32)
    bv = rng.standard_normal(o).astype(np.float32) if bias else None
    return x, w, bv


@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (2, 16, 300, 24, 3, 1), (1, 12, 260, 8, 7, 3), (2, 8, 330, 16, 11, 5)])
def test_conv1d_matches_nlc_pallas(b, c, t, o, k, dil):
    x, w, bv = _case(b, c, t, o, k)
    want = conv1d_nlc_pallas(jx(x.transpose(0, 2, 1)), jx(w), jx(bv),
                             dilation=dil, interpret=True)
    got = conv1d(tt(x), tt(w), tt(bv), dilation=dil)
    assert_close(got.transpose(1, 2), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (2, 16, 400, 16, 3, 1), (1, 8, 700, 24, 7, 2), (1, 24, 300, 1, 7, 1)])
def test_conv1d_matches_ncl_pallas(b, c, t, o, k, dil, windowed):
    x, w, bv = _case(b, c, t, o, k, seed=1, bias=o > 1)
    want = conv1d_ncl_pallas(jx(x), jx(w), None if bv is None else jx(bv),
                             dilation=dil, interpret=True,
                             windowed=windowed)
    got = conv1d(tt(x), tt(w), None if bv is None else tt(bv), dilation=dil)
    assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_conv1d_bf16_compute():
    x, w, bv = _case(2, 16, 300, 16, 7, seed=2)
    want = conv1d_ncl_pallas(jx(x).astype(jnp.bfloat16), jx(w), jx(bv),
                             dilation=3, compute_dtype=jnp.bfloat16,
                             interpret=True)
    got = conv1d(tt(x).bfloat16(), tt(w), tt(bv), dilation=3,
                 compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("stride,dil,causal", [
    (1, 1, True), (1, 2, True), (4, 1, True), (1, 1, False), (2, 1, False)])
def test_causal_conv1d(stride, dil, causal):
    x, w, bv = _case(2, 4, 61, 6, 4 if stride > 1 else 3, seed=3)
    want = jconv.causal_conv1d(jx(x), jx(w), jx(bv), stride=stride,
                               dilation=dil, causal=causal)
    got = tconv.causal_conv1d(tt(x), tt(w), tt(bv), stride=stride,
                              dilation=dil, causal=causal)
    assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,ratio", [(True, 1.0), (False, 1.0),
                                          (True, 0.5)])
def test_causal_conv_transpose1d(causal, ratio):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 17)).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 3, 8))).astype(np.float32)
    bv = rng.standard_normal(3).astype(np.float32)
    want = jconv.causal_conv_transpose1d(jx(x), jx(w), jx(bv), stride=4,
                                         causal=causal,
                                         trim_right_ratio=ratio)
    got = tconv.causal_conv_transpose1d(tt(x), tt(w), tt(bv), stride=4,
                                        causal=causal, trim_right_ratio=ratio)
    assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stride,k", [(2, 4), (4, 8)])
def test_conv_transpose1d_poly(stride, k):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 23)).astype(np.float32)
    w = (0.3 * rng.standard_normal((8, 5, k))).astype(np.float32)
    bv = rng.standard_normal(5).astype(np.float32)
    want = jconv.conv_transpose1d_poly(jx(x), jx(w), jx(bv), stride=stride,
                                       layout="ncl")
    got = tconv.conv_transpose1d_poly(tt(x), tt(w), tt(bv), stride=stride)
    assert got.shape == (2, 5, (23 - 1) * stride + k)
    assert_close(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        tconv._poly_weight(tt(w), stride).numpy(),
        np.asarray(jconv._poly_weight(jx(w), stride)))


def test_pad1d_and_extra_padding():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    for pads in ((2, 1), (5, 6), (0, 3)):
        for mode in ("zero", "reflect"):
            assert_close(tconv.pad1d(tt(x), pads, mode=mode),
                         jconv.pad1d(jx(x), pads, mode=mode), rtol=0, atol=0)
    for args in ((100, 7, 1, 6), (240, 8, 4, 4), (13, 10, 5, 5)):
        assert tconv._extra_padding_for_conv1d(*args) == \
            jconv._extra_padding_for_conv1d(*args)
