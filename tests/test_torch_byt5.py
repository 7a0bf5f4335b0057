"""The port's ByT5 tokenizer, position buckets, encoder, HF import and
gelu_new against the JAX package.

Tolerances: token ids, masks, buckets and imported weights exactly;
gelu_new 1e-6 in fp32 (XLA's and torch's tanh may differ by an ulp) and
one bf16 ulp (2^-8 relative) in bf16; the fp32 encoder 2e-5 of its output
scale (other summation orders); the bf16 encoder 2^-7 of its output
scale, one bf16 ulp at its largest magnitude (both round each dense
output to bf16 from fp32 sums; another thread count sums in another order,
and a rounding that lands the other way moves an output by an ulp)."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.text import byt5 as jbyt5
from ditto_tts_tpu.text import gpt2 as jgpt2
from ditto_tts_tpu.text.tokenizers import ByT5Tokenizer as JaxByT5Tokenizer

from ditto_tts_tpu_torch.params import byt5_spec, fill_spec, tree_leaves
from ditto_tts_tpu_torch.text import byt5 as tbyt5
from ditto_tts_tpu_torch.text import gpt2 as tgpt2
from ditto_tts_tpu_torch.text.tokenizers import ByT5Tokenizer

from _torch_port_util import assert_close, jitter, jx, np_of, tt

TEXTS = ["Hello, world!",
         "Le cœur déçu mais l'âme plutôt naïve, Louÿs rêva de crapaüter",
         "çà et là", ""]
TINY = jbyt5.ByT5Config(vocab_size=80, d_model=48, d_kv=8, d_ff=96,
                        num_layers=2, num_heads=6)


def port_cfg(cfg):
    return tbyt5.ByT5Config(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("max_length,padding,truncation", [
    (None, "longest", True), (None, "max_length", True),
    (80, "max_length", True), (16, "max_length", True),
    (16, "longest", True), (80, "longest", False)])
def test_byt5_tokenizer_matches_jax(max_length, padding, truncation):
    kw = dict(max_length=max_length, padding=padding, truncation=truncation)
    want = JaxByT5Tokenizer()(TEXTS, **kw)
    got = ByT5Tokenizer()(TEXTS, **kw)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    one = ByT5Tokenizer()(TEXTS[1], **kw)
    np.testing.assert_array_equal(
        one["input_ids"], JaxByT5Tokenizer()(TEXTS[1], **kw)["input_ids"])


def test_byt5_tokenizer_ids_and_decode():
    tok = ByT5Tokenizer()
    assert tok.encode("aé") == [97 + 3, 0xC3 + 3, 0xA9 + 3, 1]
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == JaxByT5Tokenizer().encode(text)
        assert tok.decode(ids) == text


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_exact(num_buckets, max_distance):
    rp = np.arange(-1024, 1025)[None, :] - np.zeros((2, 1), np.int64)
    want = jbyt5._relative_position_bucket(rp, num_buckets, max_distance)
    got = tbyt5._relative_position_bucket(rp, num_buckets, max_distance)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _params(cfg, seed):
    """numpy ByT5 weights of the JAX init's tree, norms away from 1."""
    return jitter(fill_spec(byt5_spec(port_cfg(cfg)), seed), seed + 1)


def test_position_bias_matches_jax():
    p = _params(TINY, 0)["block0_rel"]
    want = jbyt5.position_bias(jax.tree_util.tree_map(jx, p), TINY, 37)
    got = tbyt5.position_bias(jax.tree_util.tree_map(tt, p), port_cfg(TINY),
                              37)
    np.testing.assert_array_equal(np_of(got), np_of(want))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2.0 ** -7)])
def test_byt5_encode_matches_jax(dtype, tol):
    p = _params(TINY, 2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY.vocab_size, (3, 20))
    mask = np.zeros((3, 20), np.int32)
    for i, n in enumerate((20, 13, 5)):
        mask[i, :n] = 1
    jp = jax.tree_util.tree_map(lambda a: jx(a).astype(dtype), p)
    tp = jax.tree_util.tree_map(lambda a: tt(a).to(getattr(torch, dtype)), p)
    want = np_of(jbyt5.byt5_encode(jp, TINY, jx(ids), jx(mask)))
    got = tbyt5.byt5_encode(tp, port_cfg(TINY), tt(ids), tt(mask))
    assert str(got.dtype) == f"torch.{dtype}"
    scale = np.abs(want).max()
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=tol * scale)
    # the unmasked call too (the bias alone)
    want = np_of(jbyt5.byt5_encode(jp, TINY, jx(ids)))
    got = tbyt5.byt5_encode(tp, port_cfg(TINY), tt(ids))
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=tol * scale)


def test_byt5_import_hf_state_dict_matches_jax():
    rng = np.random.default_rng(4)
    d, inner, dff = TINY.d_model, TINY.inner_dim, TINY.d_ff
    sd = {"shared.weight": rng.standard_normal((TINY.vocab_size, d)),
          "encoder.final_layer_norm.weight": rng.standard_normal(d),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
          ".weight": rng.standard_normal((32, TINY.num_heads))}
    for i in range(TINY.num_layers):
        b = f"encoder.block.{i}"
        for n, shape in (("q", (inner, d)), ("k", (inner, d)),
                         ("v", (inner, d)), ("o", (d, inner))):
            sd[f"{b}.layer.0.SelfAttention.{n}.weight"] = \
                rng.standard_normal(shape)
        for n, shape in (("wi_0", (dff, d)), ("wi_1", (dff, d)),
                         ("wo", (d, dff))):
            sd[f"{b}.layer.1.DenseReluDense.{n}.weight"] = \
                rng.standard_normal(shape)
        for j in (0, 1):
            sd[f"{b}.layer.{j}.layer_norm.weight"] = rng.standard_normal(d)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = list(tree_leaves(jax.tree_util.tree_map(
        np.asarray, jbyt5.import_hf_state_dict(sd, TINY))))
    got = list(tree_leaves(tbyt5.import_hf_state_dict(sd, port_cfg(TINY))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -8)])
def test_gelu_new_matches_jax(dtype, rtol):
    x = (3.0 * np.random.default_rng(5).standard_normal(4096)).astype(
        np.float32)
    want = jgpt2.gelu_new(jx(x).astype(dtype))
    got = tgpt2.gelu_new(tt(x).to(getattr(torch, dtype)))
    assert_close(got, want, rtol=rtol, atol=1e-6)
