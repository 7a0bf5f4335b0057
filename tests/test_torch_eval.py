"""The port's evaluation leg against the JAX package at small sizes: S2T
(encode, decode_logits, greedy ids under the margin rule, the fbank),
ECAPA (with and without a mask), the metrics, the S2T tokenizer,
``orthogonal_reinit`` on the serving trees, the random-init specs, and the
timing, profiling and plotting helpers on the CPU. Inputs and weights come
from numpy seeds; S2T and ECAPA are held to 1e-4 of max|JAX|, the text
metrics, the fbank and the re-init bit for bit."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.eval import metrics as jmetrics
from ditto_tts_tpu.models import ecapa as jecapa
from ditto_tts_tpu.models import s2t as js2t
from ditto_tts_tpu.text.s2t_tokenizer import S2TTokenizer as JTok
from ditto_tts_tpu.utils.smoke import orthogonal_reinit as j_ortho

from ditto_tts_tpu_torch import assets
from ditto_tts_tpu_torch.eval import metrics as tmetrics
from ditto_tts_tpu_torch.eval.plots import plot_from_checkpoint, plot_history
from ditto_tts_tpu_torch.eval.throughput import (synthesis_throughput,
                                                 time_fn,
                                                 train_step_throughput)
from ditto_tts_tpu_torch.models import ecapa as tecapa
from ditto_tts_tpu_torch.models import s2t as ts2t
from ditto_tts_tpu_torch.params import (ecapa_spec, fill_spec, s2t_spec,
                                        tree_leaves, tree_map)
from ditto_tts_tpu_torch.text.s2t_tokenizer import S2TTokenizer as TTok
from ditto_tts_tpu_torch.utils.profiling import (annotate, check_determinism,
                                                 trace)
from ditto_tts_tpu_torch.utils.smoke import orthogonal_reinit as t_ortho

from _torch_port_util import jax_generator_params, jitter, port_params

TOL = 1e-4      # max |port - JAX| / max |JAX| for S2T and ECAPA

S2T_J = js2t.S2TConfig(vocab_size=61, d_model=16, encoder_layers=2,
                       decoder_layers=2, encoder_heads=2, decoder_heads=2,
                       encoder_ffn=32, decoder_ffn=32, conv_channels=24,
                       input_features=12)
S2T_T = ts2t.S2TConfig(**S2T_J.__dict__)


def _trees(spec, seed):
    """(JAX tree, port tree) of one numpy draw, jittered so the norms'
    ones and zeros are not trivial."""
    arrays = jitter(fill_spec(spec, seed), seed + 100)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            tree_map(lambda a: torch.from_numpy(np.array(a)), arrays))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def s2t():
    jp, tp = _trees(s2t_spec(S2T_T), 1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 40, 12)).astype(np.float32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 30:] = 0
    return jp, tp, feats, mask


def test_s2t_encode_matches_jax(s2t):
    jp, tp, feats, mask = s2t
    want, wmask = js2t.encode(jp, S2T_J, jnp.asarray(feats),
                              jnp.asarray(mask))
    got, gmask = ts2t.encode(tp, S2T_T, torch.from_numpy(feats),
                             torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 10, 16)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    _close(got, want)


def test_s2t_decode_logits_matches_jax(s2t):
    jp, tp, feats, mask = s2t
    ids = np.array([[2, 5, 17, 33, 40, 8, 9], [2, 5, 12, 1, 1, 1, 1]])
    enc_j = js2t.encode(jp, S2T_J, jnp.asarray(feats), jnp.asarray(mask))
    enc_t = ts2t.encode(tp, S2T_T, torch.from_numpy(feats),
                        torch.from_numpy(mask))
    want = js2t.decode_logits(jp, S2T_J, jnp.asarray(ids, jnp.int32), *enc_j)
    got = ts2t.decode_logits(tp, S2T_T, torch.from_numpy(ids), *enc_t)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 61)
    _close(got, want)


def test_s2t_greedy_decode_matches_jax(s2t):
    jp, tp, feats, mask = s2t
    want = np.asarray(js2t.greedy_decode(
        jp, S2T_J, jnp.asarray(feats), jnp.asarray(mask), forced_bos_id=5,
        max_len=16))
    got = ts2t.greedy_decode(tp, S2T_T, torch.from_numpy(feats),
                             torch.from_numpy(mask), forced_bos_id=5,
                             max_len=16).numpy()
    assert got.shape == want.shape == (2, 16)
    assert (got[:, :2] == [[2, 5], [2, 5]]).all()
    # the margin rule: ids are compared before the first
    # step whose reference top-2 logit margin is under 10x the tolerance
    enc = js2t.encode(jp, S2T_J, jnp.asarray(feats), jnp.asarray(mask))
    ref_logits = torch.from_numpy(np.asarray(js2t.decode_logits(
        jp, S2T_J, jnp.asarray(want), *enc)))
    n = ts2t.greedy_compared_steps(torch.from_numpy(want), ref_logits,
                              TOL * ref_logits.abs().max().item(),
                              S2T_J.eos_token_id)
    print(f"greedy ids compared over {n} of 16 steps")
    assert n >= 8, n    # random tiny weights: ties are rare this early
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


def test_greedy_decode_attention_calls(monkeypatch, s2t):
    """encoder_layers + (max_len - 2) x decoder_layers x 2 matmul-softmax
    calls a decode, none through kernel A's entry point."""
    _, tp, feats, mask = s2t
    calls = []
    real = ts2t.attention_plain
    monkeypatch.setattr(ts2t, "attention_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ts2t.greedy_decode(tp, S2T_T, torch.from_numpy(feats),
                       torch.from_numpy(mask), forced_bos_id=5, max_len=9)
    assert len(calls) == 2 + 7 * 2 * 2


def test_log_mel_fbank_is_jax_bitwise():
    wav = 0.1 * np.random.default_rng(3).standard_normal(7000)
    for cmvn in (True, False):
        got = ts2t.log_mel_fbank(wav.astype(np.float32), 16000, cmvn=cmvn)
        want = js2t.log_mel_fbank(wav.astype(np.float32), 16000, cmvn=cmvn)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert ts2t.log_mel_fbank(np.zeros(100), 16000).shape == (0, 80)


def _spec_shapes_match(spec, jax_tree):
    got = [(p, a.shape, a.dtype) for p, a in tree_leaves(fill_spec(spec, 0))]
    want = [(p, tuple(a.shape), np.dtype(a.dtype))
            for p, a in tree_leaves(jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype), jax_tree))]
    assert got == want


def test_specs_have_the_jax_init_trees_shapes():
    _spec_shapes_match(s2t_spec(S2T_T), jax.eval_shape(
        lambda k: js2t.init_s2t(k, S2T_J), jax.random.key(0)))
    jcfg = jecapa.tiny_ecapa_config()
    _spec_shapes_match(ecapa_spec(tecapa.tiny_ecapa_config()), jax.eval_shape(
        lambda k: jecapa.init_ecapa(k, jcfg), jax.random.key(0)))
    bn = fill_spec(ecapa_spec(tecapa.ECAPAConfig()), 0)["asp_norm"]
    assert (bn["running_mean"] == 0).all() and (bn["running_var"] == 1).all()
    assert ts2t.s2t_medium_config() == ts2t.S2TConfig(
        **js2t.s2t_medium_config().__dict__)


@pytest.mark.parametrize("masked", [False, True])
def test_ecapa_embed_matches_jax(masked):
    jcfg = jecapa.tiny_ecapa_config()
    tcfg = tecapa.tiny_ecapa_config()
    jp, tp = _trees(ecapa_spec(tcfg), 4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 50, 80)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 50), np.int32)
        mask[1, 35:] = 0
    want = jecapa.ecapa_embed(jp, jcfg, jnp.asarray(feats),
                              None if mask is None else jnp.asarray(mask))
    got = tecapa.ecapa_embed(tp, tcfg, torch.from_numpy(feats),
                             None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 32)
    _close(got, want)


def test_text_metrics_are_jax_exact():
    rng = np.random.default_rng(6)
    words = ["le", "la", "chat", "monde", "bonjour", "élève", "numéro"]
    refs = [" ".join(rng.choice(words, rng.integers(1, 8)))
            for _ in range(12)]
    hyps = [" ".join(rng.choice(words, rng.integers(0, 8)))
            for _ in range(12)]
    for a, b in zip(refs, hyps):
        assert tmetrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
        assert tmetrics.edit_distance(a.split(), b.split()) == \
            jmetrics.edit_distance(a.split(), b.split())
    assert tmetrics.cer(refs, hyps) == jmetrics.cer(refs, hyps)
    assert tmetrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert tmetrics.cer(refs, refs) == 0.0 and tmetrics.wer([""], ["a"]) == 1
    a, b = rng.standard_normal(192), rng.standard_normal(192)
    assert tmetrics.cosine_similarity(a, b) == \
        jmetrics.cosine_similarity(a, b)
    a32 = a.astype(np.float32)
    assert tmetrics.cosine_similarity(torch.from_numpy(a32), b) == \
        jmetrics.cosine_similarity(a32, b)


def test_mel_mae_matches_jax():
    rng = np.random.default_rng(7)
    a = (0.1 * rng.standard_normal(6000)).astype(np.float32)
    b = (a + 0.02 * rng.standard_normal(6000)).astype(np.float32)
    want = jmetrics.mel_mae(a[None], b[None, :5500])
    got = tmetrics.mel_mae(a[None], b[None, :5500], device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)
    assert tmetrics.mel_mae(torch.from_numpy(a), torch.from_numpy(a)) == 0.0


def test_sim_and_cer_wer_loops():
    rng = np.random.default_rng(8)
    wavs = [rng.standard_normal(50) for _ in range(3)]

    def embed(w):
        return w[:8]

    args = (wavs, [w + 0.1 for w in wavs], [w * 2 for w in wavs])
    assert tmetrics.sim_o_sim_r(embed, *args) == \
        jmetrics.sim_o_sim_r(embed, *args)
    pairs = [(w, "bonjour le monde") for w in wavs]
    assert tmetrics.cer_wer_on_pairs(lambda w: "bonjour la monde", pairs) \
        == jmetrics.cer_wer_on_pairs(lambda w: "bonjour la monde", pairs)


@pytest.mark.parametrize("which", ["mini", "placeholder"])
def test_s2t_tokenizer_decode_is_jax_exact(which):
    if which == "mini":
        tok = assets.s2t_mini_tokenizer()
        ref = JTok.from_file(assets.S2T_MINI_VOCAB)
        n = 122
    else:
        tok, ref = TTok.placeholder(300), JTok.placeholder(300)
        n = 300
    assert tok.lang_code_to_id == ref.lang_code_to_id
    assert tok.lang_code_to_id["fr"] == 5
    rng = np.random.default_rng(9)
    seqs = [[2, 5] + list(rng.integers(0, n + 3, 20)) for _ in range(8)]
    seqs += [[2, 5, 40, 2, 41], [5, 40, 41], [], [2]]
    for ids in seqs:
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip)
    assert tok.batch_decode(np.array(seqs[:3])) == \
        ref.batch_decode(np.array(seqs[:3]))
    up, ref_up = (TTok(tok.vocab, do_upper_case=True),
                  JTok(ref.vocab, do_upper_case=True))
    assert up.decode(seqs[0]) == ref_up.decode(seqs[0])


def test_orthogonal_reinit_is_jax_bitwise():
    jp = jax_generator_params()
    tp = port_params(jp)
    for field in ("codec", "vocoder"):
        want = j_ortho(getattr(jp, field), seed=3)
        got = t_ortho(getattr(tp, field), seed=3)
        w = list(tree_leaves(jax.tree_util.tree_map(np.asarray, want)))
        g = list(tree_leaves(got))
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == torch.float32, path
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    # 1-D leaves stay; a bf16 matrix keeps its dtype
    tree = {"b": torch.ones(3), "w": torch.zeros((4, 6), dtype=torch.bfloat16)}
    out = t_ortho(tree, gain=1.0)
    assert out["b"] is tree["b"] and out["w"].dtype == torch.bfloat16
    w = out["w"].float().numpy()
    np.testing.assert_allclose(w @ w.T, np.eye(4), atol=2e-2)


def test_time_fn_throughput_and_determinism():
    x = torch.ones((8, 8))

    def f(a):
        return {"y": a * 2, "z": [a + 1]}

    assert time_fn(f, x, iters=2) > 0
    out = synthesis_throughput(f, (x,), batch=4, utterance_seconds=10,
                               iters=2)
    assert out["audio_seconds_per_second_per_chip"] > 0
    assert out["rtf"] == pytest.approx(out["seconds_per_batch"] / 40)
    tr = train_step_throughput(lambda s, fz, b, g: (s, {"loss": b.sum()}),
                               {}, {}, x, None, batch_size=2,
                               utterance_seconds=10, iters=2)
    assert tr["seconds_per_step"] > 0
    assert tr["audio_seconds_per_second_per_chip"] == pytest.approx(
        20 / tr["seconds_per_step"])
    assert check_determinism(f, x)
    g = torch.Generator().manual_seed(0)
    assert not check_determinism(lambda: torch.rand(3, generator=g))


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("eval_leg"):
            torch.ones(4).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    assert "eval_leg" in path.read_text()


def test_plots(tmp_path):
    hist = {"params": {"model_name": "DiTTO"},
            "train": {"loss": [2.0, 1.5, 1.2], "metrics": [{}] * 3},
            "validation": {"loss": [1.9, None, 1.3], "metrics": [{}] * 3}}
    out = plot_history(hist, str(tmp_path / "curve.png"))
    assert os.path.getsize(out) > 1000
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    ck = tmp_path / "DiTTO_final"
    with open(str(ck) + ".json", "w") as f:
        json.dump({"history": hist}, f)
    out2 = plot_from_checkpoint(str(ck) + ".npz", str(tmp_path / "c2.png"))
    assert os.path.getsize(out2) > 1000
    with pytest.raises(ValueError):
        plot_from_checkpoint(str(tmp_path / "none.npz"),
                             str(tmp_path / "c3.png"))
