"""Kernels A, B, C and D against their plain versions on the card, at
small and ragged shapes the serving path does not reach (causal and
kv-length masks, D=128, strided q/k/v, odd channel counts, tails shorter
than a tile, T shorter than the activation's 8-sample halo, kernel C's
residual and output type, kernel D on [B, C, T], [B, T, C] and strided
views). Every test skips without a CUDA card (the ``gen`` fixture decides,
at run time). On the card, where JAX is absent and tests/conftest.py
cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: max |kernel - plain| <= tol * max |plain|, tol 2e-5 in fp32
(another summation order) and 1e-2 in bf16 (a few bf16 ulps). The bf16
kernels A, B and C run on the tensor cores in tiles of 64 keys / 16 query
rows a warp and 32 input channels x 16..192 output channels x 128..256
time steps (C: a slab of every input channel, activated in runs of 16
rows), and kernel D in runs of 16 samples a thread, so the edge cases sit
on either side of those tiles and runs. Kernel A's gradient (its
``autograd.Function``: the kernel forward, the stock-op backward) is held
against autograd through the plain version at the same tile edges; B, C
and D, which have no backward, refuse an input that requires grad.

Kernel A's two launches for a KV cache (VALL-E) are held to the plain
version with the same masks: the prefix-causal mask at either side of the
64-key tiles, the key length read on the device (one, or one a row), and
the decode launch over a cache of 1,103 positions at heads of 64 and 128;
the unmasked launch gives the masked launch's bits at prefix 0.

Kernel D's polyphase mode is held to
``polyphase_anti_aliased_activation`` with ``snake_beta`` run as stock
ops on the card, which it follows op for op (only the card's fused
multiply-adds differ): fp32 within 1e-6 of max |plain|; bf16 within one
bf16 ulp of each value, plus that fp32 allowance for the values so near
zero that their ulp is smaller than it. The first and last 8 samples of
each row, where the polyphase edges differ from the Pallas ones, are
checked apart.

Kernel E (the DiT block's glue, ``ops/dit_glue.py``) is held to the eager
ops it replaces, run on the card, at ditto-base's widths (bf16, 8 x 750
rows of 768, heads of 64, ff 3072), at ditto-ref's (fp32, one head of 768),
at odd row counts, at a row narrower than a warp's vectors and at rows
between those widths (add_norm's other register layouts): qkv_rope,
bias_heads, gelu_gate and add_norm's sum equal them bit for bit;
add_norm's layer_norm, whose statistics sum in another order than
PyTorch's reductions, is within one ulp of the compute dtype of each value
plus 8 fp32 ulps of the largest (2^-20 max |xn|), for the values so near
zero that their own ulp is smaller than the statistics' rounding.
"""

import pytest
import torch

from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch.ops.act_conv import (aa_snake_conv1d_cuda,
                                              aa_snake_conv1d_plain)
from ditto_tts_tpu_torch.ops.attention import (attention, attention_cuda,
                                              attention_plain)
from ditto_tts_tpu_torch.ops.conv import (conv1d, conv1d_cuda,
                                          conv1d_ncl_batched, conv1d_plain)
from ditto_tts_tpu_torch.ops import dit_glue
from ditto_tts_tpu_torch.ops.rope import rope_tables
from ditto_tts_tpu_torch.ops.snake import (polyphase_anti_aliased_activation,
                                          snake_beta, snake_coeffs)
from ditto_tts_tpu_torch.ops.snake_fused import (fused_snake_cuda,
                                                 fused_snake_plain,
                                                 polyphase_snake,
                                                 polyphase_snake_cuda)

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
@pytest.mark.parametrize("sk", [1, 15, 63, 64, 65, 750])
@pytest.mark.parametrize("sq", [1, 15, 63, 64, 65, 750])
def test_attention_kernel_tile_edges(gen, dtype, sq, sk):
    """Query and key counts on either side of the 16-row and 64-key tiles,
    each unmasked, causal, and with a kv_len short of Sk."""
    q = _rn(gen, 1, 2, sq, 64, dtype=dtype)
    k, v = (_rn(gen, 1, 2, sk, 64, dtype=dtype) for _ in range(2))
    for causal, kv_len in ((False, None), (True, None),
                           (False, max(1, sk - 7))):
        _check(attention_cuda(q, k, v, causal=causal, kv_len=kv_len),
               attention_plain(q, k, v, causal=causal, kv_len=kv_len), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,causal,kv_len", [
    (65, 64, False, 40), (750, 750, True, None), (63, 129, False, 100)])
def test_attention_kernel_d128(gen, dtype, sq, sk, causal, kv_len):
    q = _rn(gen, 2, 3, sq, 128, dtype=dtype)
    k, v = (_rn(gen, 2, 3, sk, 128, dtype=dtype) for _ in range(2))
    _check(attention_cuda(q, k, v, causal=causal, kv_len=kv_len),
           attention_plain(q, k, v, causal=causal, kv_len=kv_len), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernel_on_qkv_chunk_views(gen, dtype):
    """The DiT's layout: q, k, v are chunks of one [B, S, 3*H*D] projection
    seen as [B, H, S, D] (offsets of H*D elements, row stride 3*H*D)."""
    b, s, h, d = 2, 150, 12, 64
    qkv = _rn(gen, b, s, 3 * h * d, dtype=dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    _check(attention_cuda(q, k, v), attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sk", [1024, 4096])
def test_attention_kernel_fp32_alike_values(gen, sk, d):
    """fp32 over many keys whose values are alike, as in the DiT's
    cross-attention over 1024 text ids: within the fp32 tolerance of an
    fp64 reference, which one running sum of all Sk products (~Sk x 2^-26
    of the output) misses."""
    q = _rn(gen, 2, 4, 750, d, scale=3.0)
    k = _rn(gen, 2, 4, sk, d, scale=0.05)
    v = 0.05 + _rn(gen, 2, 4, sk, d, scale=0.005)
    _check(attention_cuda(q, k, v),
           attention_plain(q.double(), k.double(), v.double()),
           torch.float32)


def _bf16(gen, *shape):
    return _rn(gen, *shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("sq,prefix", [(70, 0), (70, 3), (70, 64), (70, 65),
                                       (200, 128), (353, 128), (129, 129)])
def test_attention_kernel_prefix(gen, sq, prefix):
    """A's masked launch with a prefix: rows see the first ``prefix`` keys
    and the keys up to themselves (VALL-E's AR prefill)."""
    q = _bf16(gen, 2, sq, 3, 64).transpose(1, 2)
    k, v = (_bf16(gen, 2, 3, sq + 40, 64) for _ in range(2))
    before = dict(kernels.launches)
    got = attention(q, k, v, causal=True, prefix=prefix, kv_len=sq)
    assert kernels.launches["attention"] == before["attention"] + 1
    assert kernels.launches["kv_decode"] == before["kv_decode"]
    _check(got, attention_plain(q, k, v, causal=True, prefix=prefix,
                                kv_len=sq), torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lengths", [[70], [1, 64, 65], [200, 3, 129]])
def test_attention_kernel_device_lengths(gen, causal, lengths):
    """A's masked launch with the key length read on the device, one or
    one a batch row; the host kv_len is not read."""
    b = 3
    q = _bf16(gen, b, 2, 200, 64)
    k, v = (_bf16(gen, b, 2, 200, 64) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = attention(q, k, v, causal=causal, kv_lens=lens, kv_len=1)
    _check(got, attention_plain(q, k, v, causal=causal, kv_lens=lens),
           torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lengths", [[1], [17], [1103], [1, 63, 64, 65],
                                     [700, 1103, 2, 333]])
def test_kv_decode_kernel(gen, d, lengths):
    """The decode launch: one query a (row, head) over the first kv_len
    keys of a cache [B, H, 1103, d] read in place, the length from the
    device; q a view of a packed [B, 1, 3, H, d] projection."""
    b = 4
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qkv = _bf16(gen, b, 1, 3, 16, d)
    q = qkv[:, :, 0].transpose(1, 2)
    k, v = (_bf16(gen, b, 16, 1103, d) for _ in range(2))
    before = dict(kernels.launches)
    got = attention(q, k, v, kv_lens=lens)
    assert kernels.launches["kv_decode"] == before["kv_decode"] + 1
    assert kernels.launches["attention"] == before["attention"]
    assert got.shape == (b, 16, 1, d)
    _check(got, attention_plain(q, k, v, kv_lens=lens), torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,kv_len", [(15, 63, 63), (64, 65, 65),
                                          (750, 750, 750), (200, 300, 250)])
def test_attention_unmasked_launch_equals_the_masked_one(gen, causal, sq, sk,
                                                         kv_len):
    """Calls without the new options launch A's unmasked kernel, whose
    body the masked launch shares: at prefix 0 and the same length read
    on the device, the two give the same bits."""
    q = _bf16(gen, 2, sq, 3, 64).transpose(1, 2)
    k, v = (_bf16(gen, 2, 3, sk, 64) for _ in range(2))
    old = attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
    lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    assert torch.equal(old, attention_cuda(q, k, v, causal=causal,
                                           kv_lens=lens))


def test_masked_options_refuse_fp32_and_grad(gen):
    q, k, v = (_rn(gen, 1, 2, 8, 64) for _ in range(3))
    with pytest.raises(TypeError, match="bf16"):
        attention_cuda(q, k, v, causal=True, prefix=2)
    qb = q.to(torch.bfloat16).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        attention(qb, k.bfloat16(), v.bfloat16(), causal=True, prefix=2)


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
@pytest.mark.parametrize("o", [1, 24, 48, 3072])
@pytest.mark.parametrize("c", [1, 24, 100])
def test_conv1d_kernel_channel_edges(gen, dtype, c, o):
    """Input channels short of the 32-channel chunk (1, 24) or past a
    whole number of them (100), output channels at every tile height; a
    ragged T, with and without bias."""
    k, dil, t = 7, 3, 389
    x = _rn(gen, 2, c, t + (k - 1) * dil, dtype=dtype)
    w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
    for bias in (None, _rn(gen, o)):
        _check(conv1d_cuda(x, w, bias, dilation=dil),
               conv1d_plain(x, w, bias, dilation=dil), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", list(range(1, 12)))
def test_conv1d_kernel_taps(gen, dtype, k):
    """Every tap count with dilations up to 5 (halos of 0..50 samples) and
    time lengths just past a 128- and a 256-step tile."""
    for dil, t, c, o in ((1 + k % 5, 129, 40, 70), (5, 257, 33, 24)):
        x = _rn(gen, 1, c, t + (k - 1) * dil, dtype=dtype)
        w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
        bias = _rn(gen, o)
        _check(conv1d_cuda(x, w, bias, dilation=dil),
               conv1d_plain(x, w, bias, dilation=dil), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_in", [300, 301])
def test_conv1d_kernel_odd_offset(gen, dtype, t_in):
    """A contiguous x that starts one element into its storage: the bf16
    kernel reads time pairs as 32-bit words only where they are aligned."""
    c, o, k = 40, 24, 3
    flat = _rn(gen, 1 + 2 * c * t_in, dtype=dtype)
    x = flat[1:].view(2, c, t_in)
    assert x.is_contiguous()
    w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
    _check(conv1d_cuda(x, w, None, dilation=2),
           conv1d_plain(x, w, None, dilation=2), dtype)


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


@pytest.mark.parametrize("ydtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (1, 8, 40, 8, 3, 1), (2, 24, 301, 24, 7, 3), (1, 48, 600, 48, 11, 5),
    (1, 5, 9, 3, 11, 5)])
def test_act_conv_kernel_residual(gen, dtype, ydtype, b, c, t, o, k, dil):
    x = _rn(gen, b, c, t, dtype=dtype, scale=2.0)
    a = torch.exp(_rn(gen, c, scale=0.3))
    inv_b = 1.0 / (torch.exp(_rn(gen, c, scale=0.3)) + 1e-9)
    w = _rn(gen, o, c, k, dtype=dtype, scale=(c * k) ** -0.5)
    bias = _rn(gen, o)
    for res in (None, _rn(gen, b, o, t, dtype=ydtype)):
        got = aa_snake_conv1d_cuda(x, a, inv_b, w, bias, dilation=dil,
                                   residual=res, out_dtype=ydtype)
        assert got.dtype == ydtype
        _check(got, aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil,
                                          residual=res, out_dtype=ydtype),
               torch.bfloat16 if torch.bfloat16 in (dtype, ydtype)
               else torch.float32)


@pytest.mark.parametrize("ydtype", DTYPES)
@pytest.mark.parametrize("b,c,t,o,k,dil", [
    (1, 40, 300, 70, 7, 3),      # T off BN 128, O off the 96-row tile
    (2, 100, 257, 200, 11, 5),   # O past one 192-row tile, C off 64
    (1, 64, 400, 384, 11, 5),    # two whole 192-row tiles
    (1, 70, 129, 48, 3, 1),      # the 48-row tile, BN 256, C off 32
    (1, 24, 65, 24, 11, 5),      # T just above aa_snake_conv1d's gate
    (1, 48, 129, 48, 11, 5),     # T just above aa_snake_conv1d_ncl's gate
    (1, 33, 1000, 24, 3, 1)])    # the 32-row tile, C past one chunk
def test_act_conv_kernel_tc_tile_edges(gen, ydtype, b, c, t, o, k, dil):
    """Kernel C's tensor-core path at the edges of its tiles (BM x BN of
    192 x 128 with chunks of 64 channels, 96 x 128, 48 x 256 or 32 x 256
    with chunks of 32, slab runs of 16 rows), with and without the
    residual, in a bf16 or an fp32 output."""
    bf16 = torch.bfloat16
    x = _rn(gen, b, c, t, dtype=bf16, scale=2.0)
    a = torch.exp(_rn(gen, c, scale=0.3))
    inv_b = 1.0 / (torch.exp(_rn(gen, c, scale=0.3)) + 1e-9)
    w = _rn(gen, o, c, k, dtype=bf16, scale=(c * k) ** -0.5)
    bias = _rn(gen, o)
    for res in (None, _rn(gen, b, o, t, dtype=ydtype)):
        got = aa_snake_conv1d_cuda(x, a, inv_b, w, bias, dilation=dil,
                                   residual=res, out_dtype=ydtype)
        assert got.dtype == ydtype
        _check(got, aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil,
                                          residual=res, out_dtype=ydtype),
               bf16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("up_x", [True, False])
@pytest.mark.parametrize("t", [7, 15, 16, 17, 3748, 4097])
def test_snake_kernel_run_edges(gen, dtype, up_x, t):
    """Kernel D's 16-sample runs: T shorter than one run, one run, one run
    + 1, rows off the 16-byte grid (T = 3748, the 768-wide stage's, whose
    runs start shifted) and one past a block's 4096 samples, on a [B, C, T]
    tensor and on one that starts an odd number of elements into its
    storage (the runs of every row start shifted there)."""
    b, c = 2, 3
    flat = _rn(gen, 1 + b * c * t, dtype=dtype, scale=2.0)
    a = torch.exp(_rn(gen, c, scale=0.3))
    inv_b = 1.0 / (torch.exp(_rn(gen, c, scale=0.3)) + 1e-9)
    for x in (flat[:-1].view(b, c, t), flat[1:].view(b, c, t)):
        _check(fused_snake_cuda(x, a, inv_b, up_in_x_dtype=up_x),
               fused_snake_plain(x, a, inv_b, up_in_x_dtype=up_x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("up_x", [True, False])
@pytest.mark.parametrize("b,c,t,view", [
    (1, 3, 5, "bct"), (2, 7, 513, "bct"), (1, 1, 1, "bct"),
    (1, 33, 130, "btc"), (2, 40, 7, "btc"), (3, 70, 1000, "strided")])
def test_snake_kernel(gen, dtype, up_x, b, c, t, view):
    if view == "bct":
        x = _rn(gen, b, c, t, dtype=dtype, scale=2.0)
    elif view == "btc":            # a [B, T, C] tensor seen as [B, C, T]
        x = _rn(gen, b, t, c, dtype=dtype, scale=2.0).transpose(1, 2)
    else:                          # every other sample of a longer signal
        x = _rn(gen, b, c, 2 * t, dtype=dtype, scale=2.0)[..., ::2]
    a = torch.exp(_rn(gen, c, scale=0.3))
    inv_b = 1.0 / (torch.exp(_rn(gen, c, scale=0.3)) + 1e-9)
    before = kernels.launches["snake"]
    got = fused_snake_cuda(x, a, inv_b, up_in_x_dtype=up_x)
    assert kernels.launches["snake"] == before + 1
    if view == "btc":
        assert got.stride() == x.stride()
    _check(got, fused_snake_plain(x, a, inv_b, up_in_x_dtype=up_x), dtype)


def _poly_plain(x, alpha, beta, fast):
    return polyphase_anti_aliased_activation(
        x, lambda v: snake_beta(v, alpha, beta, fast=fast))


def _check_poly(got, want, dtype):
    """``polyphase_snake_cuda`` against the stock-op polyphase form, over
    the row's first 8 samples, its last 8 and the whole."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    slack = 1e-6 * w.abs().max().item()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        ulp = torch.where(w == 0, torch.zeros_like(w),
                          torch.ldexp(torch.ones_like(w), e - 8))
    else:
        ulp = torch.zeros_like(w)
    for part, sl in (("first 8", slice(0, 8)), ("last 8", slice(-8, None)),
                     ("all", slice(None))):
        err = (g[..., sl] - w[..., sl]).abs()
        bad = err > ulp[..., sl] + slack
        assert not bad.any(), (part, err.max().item(),
                               int(bad.sum().item()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("c", [1, 24, 48, 768])
@pytest.mark.parametrize("t", [1, 2, 3, 5, 15, 16, 17, 3748])
def test_polyphase_snake_kernel(gen, dtype, fast, with_beta, c, t):
    """Kernel D's polyphase mode: T shorter than the edges' reach (1-5),
    one 16-sample run and either side of it, the 768-wide stage's 3748,
    on a [B, C, T] tensor and on one an odd number of elements into its
    storage; one launch each."""
    b = 2
    flat = _rn(gen, 1 + b * c * t, dtype=dtype, scale=2.0)
    alpha = _rn(gen, c, scale=0.3)
    beta = _rn(gen, c, scale=0.3) if with_beta else None
    a, inv_b = snake_coeffs(alpha, beta)
    for x in (flat[:-1].view(b, c, t), flat[1:].view(b, c, t)):
        before = kernels.launches["snake"]
        got = polyphase_snake_cuda(x, a, inv_b, fast=fast)
        assert kernels.launches["snake"] == before + 1
        _check_poly(got, _poly_plain(x, alpha, beta, fast), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("c,t", [(48, 119936), (24, 239872)])
def test_polyphase_snake_kernel_path_lengths(gen, dtype, fast, c, t):
    """The 48- and 24-wide stages' lengths in a 10 s request, also at an
    odd storage offset."""
    flat = _rn(gen, 1 + c * t, dtype=dtype, scale=2.0)
    alpha, beta = _rn(gen, c, scale=0.3), _rn(gen, c, scale=0.3)
    a, inv_b = snake_coeffs(alpha, beta)
    for x in (flat[:-1].view(1, c, t), flat[1:].view(1, c, t)):
        _check_poly(polyphase_snake_cuda(x, a, inv_b, fast=fast),
                    _poly_plain(x, alpha, beta, fast), dtype)


@pytest.mark.parametrize("view", ["btc", "strided"])
def test_polyphase_snake_kernel_views(gen, view):
    """A [B, T, C] tensor seen as [B, C, T] (channels-minor runs) and every
    other sample of a longer signal."""
    b, c, t = 2, 40, 300
    if view == "btc":
        x = _rn(gen, b, t, c, dtype=torch.bfloat16, scale=2.0).transpose(1, 2)
    else:
        x = _rn(gen, b, c, 2 * t, dtype=torch.bfloat16, scale=2.0)[..., ::2]
    alpha, beta = _rn(gen, c, scale=0.3), _rn(gen, c, scale=0.3)
    a, inv_b = snake_coeffs(alpha, beta)
    _check_poly(polyphase_snake_cuda(x, a, inv_b, fast=True),
                _poly_plain(x, alpha, beta, True), torch.bfloat16)


def test_polyphase_snake_launches_on_the_card(gen):
    """The entry launches kernel D once on a CUDA tensor, with its
    coefficients from ``snake_coeffs`` (linear scale and plain Snake
    included)."""
    x = _rn(gen, 2, 24, 1000, dtype=torch.bfloat16, scale=2.0)
    alpha = _rn(gen, 24, scale=0.3).abs() + 0.5
    for beta, logscale in ((None, True), (alpha + 0.1, False)):
        before = kernels.launches["snake"]
        got = polyphase_snake(x, alpha, beta, logscale=logscale, fast=True)
        assert kernels.launches["snake"] == before + 1
        a, inv_b = snake_coeffs(alpha, beta, logscale=logscale)
        assert torch.equal(got, polyphase_snake_cuda(x, a, inv_b, fast=True))
        _check_poly(got, polyphase_anti_aliased_activation(
            x, lambda v: snake_beta(v, alpha, beta, logscale=logscale,
                                    fast=True)), torch.bfloat16)


@pytest.mark.parametrize("b,c,t,o,k,dil", [(8, 32, 3000, 32, 3, 1),
                                           (1, 16, 500, 16, 3, 2)])
def test_conv1d_ncl_batched_launches_kernel_b(gen, b, c, t, o, k, dil):
    x = _rn(gen, b, c, t)
    w = _rn(gen, o, c, k, scale=(c * k) ** -0.5)
    bias = _rn(gen, o)
    before = kernels.launches["conv1d"]
    got = conv1d_ncl_batched(x, w, bias, dilation=dil)
    assert kernels.launches["conv1d"] == before + 1
    _check(got, conv1d_plain(x, w, bias, dilation=dil), torch.float32)


@pytest.mark.parametrize("b,c,t,o,k,dil", [(8, 32, 3000, 32, 3, 1),
                                           (1, 16, 500, 16, 3, 2)])
def test_conv1d_ncl_batched_bf16(gen, b, c, t, o, k, dil):
    """#4 in bf16: the whole batch in one launch of the tensor-core kernel."""
    x = _rn(gen, b, c, t, dtype=torch.bfloat16)
    w = _rn(gen, o, c, k, dtype=torch.bfloat16, scale=(c * k) ** -0.5)
    bias = _rn(gen, o)
    before = kernels.launches["conv1d"]
    got = conv1d_ncl_batched(x, w, bias, dilation=dil)
    assert kernels.launches["conv1d"] == before + 1
    assert got.dtype == torch.bfloat16
    _check(got, conv1d_plain(x, w, bias, dilation=dil), torch.bfloat16)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rn(gen, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda(q, q, q)
    # bf16 operands feed 16-byte copies: a view one element off, or a row
    # stride that is not a multiple of 8, is refused (fp32 takes both)
    buf = _rn(gen, 1, 2, 9 * 64 + 1, dtype=torch.bfloat16)
    off = buf[..., 1:].reshape(1, 2, 9, 64)
    with pytest.raises(ValueError, match="aligned"):
        attention_cuda(off, off, off)
    odd = _rn(gen, 1, 2, 9, 65, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        attention_cuda(odd, odd, odd)
    _check(attention_cuda(odd.float(), odd.float(), odd.float()),
           attention_plain(odd.float(), odd.float(), odd.float()),
           torch.float32)
    x = _rn(gen, 1, 4, 40)
    with pytest.raises(ValueError, match="K=12"):
        conv1d_cuda(x, _rn(gen, 4, 4, 12))
    with pytest.raises(TypeError):
        conv1d_cuda(x.half(), _rn(gen, 4, 4, 3).half())
    with pytest.raises(ValueError, match="odd"):
        aa_snake_conv1d_cuda(x, torch.ones(4, device="cuda"),
                             torch.ones(4, device="cuda"), _rn(gen, 4, 4, 4))
    with pytest.raises(TypeError):
        fused_snake_cuda(x.half(), torch.ones(4, device="cuda"),
                         torch.ones(4, device="cuda"), up_in_x_dtype=True)
    with pytest.raises(ValueError, match="residual"):
        aa_snake_conv1d_cuda(x, torch.ones(4, device="cuda"),
                             torch.ones(4, device="cuda"), _rn(gen, 4, 4, 3),
                             residual=_rn(gen, 1, 4, 39))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None),
                                           (False, -3)])
@pytest.mark.parametrize("sq,sk", [(15, 63), (16, 64), (17, 65), (63, 1),
                                   (65, 129), (64, 750)])
def test_attention_gradient_tile_edges(gen, dtype, sq, sk, causal, kv_len):
    """dq, dk and dv through kernel A's Function against autograd through
    ``attention_plain``, queries and keys on either side of the 16-row and
    64-key tiles (BQ, BK of csrc/attention.cu); one launch, in the forward
    only."""
    kvl = None if kv_len is None else max(1, sk + kv_len)
    ops = [_rn(gen, 1, 2, n, 64, dtype=dtype) for n in (sq, sk, sk)]
    g = _rn(gen, 1, 2, sq, 64, dtype=dtype)
    a = [t.clone().requires_grad_() for t in ops]
    before = kernels.launches["attention"]
    got = torch.autograd.grad(attention(*a, causal=causal, kv_len=kvl), a, g)
    assert kernels.launches["attention"] == before + 1
    p = [t.clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(
        attention_plain(*p, causal=causal, kv_len=kvl), p, g)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        _check(x, y, dtype)


def test_kernels_without_backward_refuse_grad(gen):
    """B, C and D raise on an input that requires grad under grad mode,
    launch nothing, and run under torch.no_grad()."""
    x = _rn(gen, 1, 4, 64).requires_grad_()
    w = _rn(gen, 4, 4, 3)
    ones = torch.ones(4, device="cuda")
    before = dict(kernels.launches)
    for call in (lambda: conv1d_cuda(x, w),
                 lambda: conv1d(x, w),
                 lambda: conv1d_cuda(x.detach(), w.requires_grad_()),
                 lambda: aa_snake_conv1d_cuda(x, ones, ones, w.detach()),
                 lambda: fused_snake_cuda(x, ones, ones,
                                          up_in_x_dtype=False),
                 lambda: polyphase_snake_cuda(x, ones, ones, fast=True)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert kernels.launches == before
    with torch.no_grad():
        _check(conv1d_cuda(x, w), conv1d_plain(x, w), torch.float32)
    assert kernels.launches["conv1d"] == before["conv1d"] + 1


# kernel E: (dtype, B, S, hidden, heads, ff)
GLUE_SHAPES = {
    "base": (torch.bfloat16, 8, 750, 768, 12, 3072),
    "ref": (torch.float32, 8, 750, 768, 1, 3072),
    "base_odd_rows": (torch.bfloat16, 1, 37, 768, 12, 3072),
    "ref_odd_rows": (torch.float32, 3, 37, 768, 1, 3072),
    "narrow_bf16": (torch.bfloat16, 2, 41, 32, 2, 128),
    "narrow_fp32": (torch.float32, 3, 37, 32, 2, 128),
    "mid_fp32": (torch.float32, 2, 19, 384, 6, 1536),
    "wide_bf16": (torch.bfloat16, 1, 37, 1024, 16, 4096)}


def _glue_case(gen, name):
    dtype, b, s, h, nh, ff = GLUE_SHAPES[name]
    return dtype, b, s, h, nh, ff, dict(
        rn=lambda *shape, scale=1.0: _rn(gen, *shape, dtype=dtype,
                                         scale=scale))


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def _within_an_ulp(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    bits = 8 if dtype == torch.bfloat16 else 24
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - bits))
    err = (g - w).abs()
    bad = err > ulp + 2.0 ** -20 * w.abs().max()
    assert not bad.any(), (err.max().item(), int(bad.sum().item()))


@pytest.mark.parametrize("name", list(GLUE_SHAPES))
def test_dit_glue_qkv_rope_kernel(gen, name):
    """q, k and v of the packed in_proj output, and the cross-attention's
    q, bit for bit; each one launch."""
    dtype, b, s, h, nh, _, t = _glue_case(gen, name)
    qkv, bias = t["rn"](b, s, 3 * h, scale=2.0), t["rn"](3 * h, scale=0.5)
    cos, sin = rope_tables(s, h // nh, dtype=dtype, device="cuda")
    before = kernels.launches["dit_glue"]
    got = dit_glue.qkv_rope_cuda(qkv, bias, nh, cos, sin)
    assert kernels.launches["dit_glue"] == before + 1
    for g, w in zip(got, dit_glue.qkv_rope_plain(qkv, bias, nh, cos, sin)):
        _equal(g, w)
    y = qkv[..., :h].contiguous()
    _equal(dit_glue.bias_heads_cuda(y, bias[:h], nh),
           dit_glue.bias_heads_plain(y, bias[:h], nh))
    assert kernels.launches["dit_glue"] == before + 2


@pytest.mark.parametrize("name", list(GLUE_SHAPES))
def test_dit_glue_gelu_gate_kernel(gen, name):
    dtype, b, s, _, _, ff, t = _glue_case(gen, name)
    a, g = t["rn"](b, s, ff, scale=3.0), t["rn"](b, s, ff, scale=3.0)
    ba, bg = t["rn"](ff, scale=0.5), t["rn"](ff, scale=0.5)
    before = kernels.launches["dit_glue"]
    got = dit_glue.gelu_gate_cuda(a, ba, g, bg)
    assert kernels.launches["dit_glue"] == before + 1
    _equal(got, dit_glue.gelu_gate_plain(a, ba, g, bg))


@pytest.mark.parametrize("variant", ["add_norm", "no_bias", "norm_only",
                                     "add_only"])
@pytest.mark.parametrize("name", list(GLUE_SHAPES))
def test_dit_glue_add_norm_kernel(gen, name, variant):
    """The residual sum bit for bit, its layer_norm within an ulp: after an
    out_proj, after ref_compat's bare attention output (no bias), the first
    block's norm1 alone, the last block's sum alone; one launch each."""
    dtype, b, s, h, _, _, t = _glue_case(gen, name)
    res = t["rn"](b, s, h, scale=2.0)
    y = None if variant == "norm_only" else t["rn"](b, s, h)
    bias = t["rn"](h, scale=0.5) if variant in ("add_norm",
                                                "add_only") else None
    norm = {"weight": (1.0 + t["rn"](h, scale=0.2).float()).to(dtype),
            "bias": t["rn"](h, scale=0.2)}
    norm = None if variant == "add_only" else norm
    before = kernels.launches["dit_glue"]
    x, xn = dit_glue.add_norm_cuda(y, bias, res, norm)
    assert kernels.launches["dit_glue"] == before + 1
    want_x, want_xn = dit_glue.add_norm_plain(y, bias, res, norm)
    _equal(x, want_x)
    if norm is None:
        assert xn is None
    else:
        _within_an_ulp(xn, want_xn, dtype)


def test_dit_glue_refuses_what_it_does_not_take(gen):
    """Kernel E has no backward, takes fp32 or bf16 of one type and
    16-byte aligned rows; a refused call launches nothing."""
    y = _rn(gen, 2, 5, 64, dtype=torch.bfloat16)
    bias = _rn(gen, 64, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        dit_glue.add_norm_cuda(y.float().requires_grad_(), None, y.float(),
                               None)
    with pytest.raises(TypeError):
        dit_glue.gelu_gate_cuda(y.half(), bias.half(), y.half(), bias.half())
    with pytest.raises(TypeError):
        dit_glue.add_norm_cuda(y.float(), None, y, None)
    odd = _rn(gen, 2 * 5 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 64)
    with pytest.raises(ValueError, match="aligned"):
        dit_glue.bias_heads_cuda(odd, bias, 4)
    with pytest.raises(ValueError, match="aligned"):
        dit_glue.add_norm_cuda(_rn(gen, 2, 5, 68, dtype=torch.bfloat16)[
            ..., :64], bias, y, None)
    assert kernels.launches == before
    with torch.no_grad():
        x = y.float().requires_grad_()
        _equal(dit_glue.add_norm_cuda(x, None, x, None)[0], x + x)
    assert kernels.launches["dit_glue"] == before["dit_glue"] + 1
    # a head's halves in whole 16-byte vectors; a row of at most 6 x 32
    with pytest.raises(ValueError, match="head width 24"):
        dit_glue.check_widths(96, 24, 384, torch.bfloat16)
    dit_glue.check_widths(96, 24, 384, torch.float32)
    with pytest.raises(ValueError, match="hidden width 2048"):
        dit_glue.check_widths(2048, 64, 8192, torch.bfloat16)
    dit_glue.check_widths(768, 768, 3072, torch.float32)
    dit_glue.check_widths(1536, 64, 6144, torch.bfloat16)
