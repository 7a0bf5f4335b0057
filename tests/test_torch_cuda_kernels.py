"""Kernels A, B and C against their plain versions on the card, at small
and ragged shapes the serving path does not reach (causal and kv-length
masks, D=128, strided q/k/v, odd channel counts, tails shorter than a
tile). Every test skips without a CUDA card (the ``gen`` fixture decides,
at run time). On the card, where JAX is absent and tests/conftest.py
cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: max |kernel - plain| <= tol * max |plain|, tol 2e-5 in fp32
(another summation order) and 1e-2 in bf16 (a few bf16 ulps).
"""

import pytest
import torch

from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch.ops.act_conv import (aa_snake_conv1d_cuda,
                                              aa_snake_conv1d_plain)
from ditto_tts_tpu_torch.ops.attention import attention_cuda, attention_plain
from ditto_tts_tpu_torch.ops.conv import conv1d_cuda, conv1d_plain

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen,
                                device="cuda")).to(dtype)


def _check(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,kv_len", [
    (1, 2, 70, 70, 64, True, None), (2, 3, 65, 129, 128, False, 100),
    (1, 1, 1, 5, 64, False, None), (2, 2, 200, 300, 128, True, 250)])
def test_attention_kernel(gen, dtype, b, h, sq, sk, d, causal, kv_len):
    q = _rn(gen, b, sq, h, d, dtype=dtype).transpose(1, 2)   # strided
    k, v = (_rn(gen, b, h, sk, d, dtype=dtype) for _ in range(2))
    before = kernels.launches["attention"]
    got = attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
    assert kernels.launches["attention"] == before + 1
    _check(got, attention_plain(q, k, v, causal=causal, kv_len=kv_len),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (1, 3, 20, 5, 3, 1), (2, 13, 300, 9, 7, 4), (1, 70, 257, 65, 11, 2),
    (3, 1, 1000, 17, 7, 1), (1, 33, 11, 1, 11, 1)])
def test_conv1d_kernel(gen, dtype, b, c, t, o, k, dil):
    x = _rn(gen, b, c, t + (k - 1) * dil, dtype=dtype)
    w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
    for bias in (None, _rn(gen, o)):
        _check(conv1d_cuda(x, w, bias, dilation=dil),
               conv1d_plain(x, w, bias, dilation=dil), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (1, 8, 40, 8, 3, 1), (2, 13, 301, 70, 7, 3), (1, 96, 600, 96, 11, 5),
    (1, 5, 9, 3, 11, 5)])
def test_act_conv_kernel(gen, dtype, b, c, t, o, k, dil):
    x = _rn(gen, b, c, t, dtype=dtype, scale=2.0)
    a = torch.exp(_rn(gen, c, scale=0.3))
    inv_b = 1.0 / (torch.exp(_rn(gen, c, scale=0.3)) + 1e-9)
    w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
    for bias in (None, _rn(gen, o)):
        _check(aa_snake_conv1d_cuda(x, a, inv_b, w, bias, dilation=dil),
               aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil),
               dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rn(gen, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda(q, q, q)
    x = _rn(gen, 1, 4, 40)
    with pytest.raises(ValueError, match="K=12"):
        conv1d_cuda(x, _rn(gen, 4, 4, 12))
    with pytest.raises(TypeError):
        conv1d_cuda(x.half(), _rn(gen, 4, 4, 3).half())
    with pytest.raises(ValueError, match="odd"):
        aa_snake_conv1d_cuda(x, torch.ones(4, device="cuda"),
                             torch.ones(4, device="cuda"), _rn(gen, 4, 4, 4))
