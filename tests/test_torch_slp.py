"""The port's transformer decoder, SLP and SLP-driven serving chain against
the JAX package, at the tiny configs of tests/test_pipeline.py.

Tolerances: the decoder and the SLP logits 1e-5 (fp32, other summation
orders); frames exactly (each test first checks that the top two logits
are further apart than the logits' tolerance, so a near tie cannot decide
it); the chain's waveform 1e-4 with the fp32 vocoder, as
test_torch_pipeline.py holds the default chain."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.core.config import AudioConfig, SLPConfig
from ditto_tts_tpu.diffusion import sampler as jsampler
from ditto_tts_tpu.diffusion.schedule import NoiseSchedule
from ditto_tts_tpu.infer import generator as jgen
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.models import slp as jslp
from ditto_tts_tpu.nn import transformer as jtr
from ditto_tts_tpu.text import byt5 as jbyt5
from ditto_tts_tpu.text import gpt2 as jgpt2

from ditto_tts_tpu_torch.infer.generator import build_synthesize_with_slp
from ditto_tts_tpu_torch.models import slp as tslp
from ditto_tts_tpu_torch.nn import transformer as ttr
from ditto_tts_tpu_torch.params import (byt5_spec, fill_spec,
                                        init_slp_params, slp_spec)
from ditto_tts_tpu_torch.text import byt5 as tbyt5

from _torch_port_util import (CFG, jax_generator_params, jitter, jx, np_of,
                              port_params, to_torch_cfg, tt)

BYT5 = jbyt5.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                        num_layers=1, num_heads=2)
TBYT5 = tbyt5.ByT5Config(**dataclasses.asdict(BYT5))
FP32_VOC = CFG.replace(vocoder=CFG.vocoder.replace(
    compute_dtype="float32", carry_dtype="float32"))
# min 0 s at 6 frames a second: frames = class * 6 < the 64-frame buffer,
# so the mask cuts every utterance
MASKED = FP32_VOC.replace(audio=AudioConfig(min_audio_seconds=0.0,
                                            frame_rate=6))
B, L = 2, 256


def _tree(fn, a):
    return jax.tree_util.tree_map(fn, a)


def _slp_params(cfg, seed):
    """numpy byt5 and slp trees of the JAX inits' structure (norm weights
    and biases jittered away from 1 and 0)."""
    tc = to_torch_cfg(cfg)
    return jitter({"byt5": fill_spec(byt5_spec(TBYT5), seed),
                   "slp": fill_spec(slp_spec(tc.slp, tc.codec.codebook_size),
                                    seed + 1)}, seed + 2)


@pytest.fixture(scope="module")
def params():
    jp = jax_generator_params()
    extra = _slp_params(CFG, 5)
    jp = dataclasses.replace(jp, byt5=_tree(jnp.asarray, extra["byt5"]),
                             slp=_tree(jnp.asarray, extra["slp"]))
    return jp, port_params(jp)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    text = rng.integers(0, 32, (B, 20))
    bids = rng.integers(3, BYT5.vocab_size, (B, 9))
    bmask = np.ones((B, 9), np.int32)
    bmask[1, 6:] = 0
    return audio, mask, text, bids, bmask


def _check_no_near_tie(logits, tol):
    top2 = np.sort(np_of(logits), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 10 * tol, top2


@pytest.mark.parametrize("nhead,causal", [(1, True), (2, True), (2, False)])
def test_transformer_decoder_matches_jax(nhead, causal):
    scfg = SLPConfig(embedding_dim=16, num_layers=2, num_heads=nhead)
    layers = jitter(fill_spec(slp_spec(to_torch_cfg(scfg), 16), 0),
                    1)["decoder"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 7, 16)).astype(np.float32)
    dec = jtr.TransformerDecoder(16, nhead, 16 * nhead, 2)
    want = dec.apply(_tree(jx, layers), jx(x), jx(mem), causal_self=causal)
    got = ttr.transformer_decoder(_tree(tt, layers), nhead, tt(x), tt(mem),
                                  causal_self=causal)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,nhead,plain", [(144, 1, True), (144, 2, False),
                                           (64, 1, False)])
def test_mha_wide_heads_take_the_matmul_softmax(monkeypatch, h, nhead,
                                                plain):
    """A head wider than 128 takes attention_plain and never attention
    (kernel A on the card), as JAX sends it to sdpa_reference; the result
    matches JAX's _mha_apply either way."""
    calls = {"attention": 0, "attention_plain": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(ttr, name, counted(name, getattr(ttr, name)))
    p = jitter(fill_spec(slp_spec(to_torch_cfg(SLPConfig(
        embedding_dim=h, num_heads=nhead)), 4), 3), 4)["decoder"][0]["self_attn"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, h)).astype(np.float32)
    want = jtr._mha_apply(_tree(jx, p), nhead, jx(x), jx(x), causal=True)
    got = ttr._mha_apply(_tree(tt, p), nhead, tt(x), tt(x), causal=True)
    assert calls == {"attention": int(not plain),
                     "attention_plain": int(plain)}
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


def test_slp_forward_matches_jax(params):
    jp, tp = params
    audio, mask, _, bids, bmask = _inputs(0)
    jfn = jax.jit(functools.partial(jslp.slp_forward, cfg=CFG.slp,
                                    byt5_cfg=BYT5, codec_cfg=CFG.codec))
    want = jfn(jp.slp, jp.byt5, jp.codec, text_ids=jx(bids),
               text_mask=jx(bmask), audio=jx(audio), padding_mask=jx(mask))
    tcfg = to_torch_cfg(CFG)
    got = tslp.slp_forward(tp.slp, tp.byt5, tp.codec, tcfg.slp, TBYT5,
                           tcfg.codec, tt(bids), tt(bmask), tt(audio),
                           tt(mask))
    assert got.shape == (B, CFG.slp.nb_classes)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


def test_slp_predict_frames_exact_with_ties():
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0], [7.0, 1.0, 7.0, 9.0]],
                      np.float32)
    want = np.asarray(jslp.slp_predict_frames(jx(logits), frame_rate=75,
                                              min_seconds=10))
    got = tslp.slp_predict_frames(tt(logits), frame_rate=75, min_seconds=10)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [825, 750, 900, 975])


def _jax_slp_chain(cfg, jp, audio, mask, text, bids, bmask, x_init, steps):
    """The body of the JAX build_synthesize_with_slp with explicit noise
    (x_init, then one draw per step into ddpm_sample's noise_seq)."""
    schedule = NoiseSchedule.cosine(cfg.dit.diffusion_steps)
    taus = jsampler.respaced_timesteps(cfg.dit.diffusion_steps,
                                       cfg.sampler.num_steps)
    max_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length)
    logits = jslp.slp_forward(jp.slp, jp.byt5, jp.codec, cfg.slp, BYT5,
                              cfg.codec, bids, bmask, audio, mask)
    frames = jslp.slp_predict_frames(
        logits, frame_rate=cfg.audio.frame_rate,
        min_seconds=int(cfg.audio.min_audio_seconds))
    text_emb = jgpt2.embed_tokens(jp.gpt2, text[:, :cfg.dit.max_token_length])

    def model_fn(x, t):
        return jdit.ditto_forward(jp.dit, cfg.dit, x, text_emb, t)

    refined = jsampler.ddpm_sample(model_fn, jax.random.key(0), x_init,
                                   schedule, taus, noise_seq=steps,
                                   clip_denoised=cfg.sampler.clip_denoised,
                                   prediction_type=cfg.dit.prediction_type)
    valid = jnp.arange(max_frames)[None, :] < frames[:, None]
    refined = refined * valid[..., None]
    wav = jgen.latents_to_waveform(jp, cfg, refined,
                                   output_length=max_frames
                                   * cfg.codec.hop_length)
    return wav, frames, logits


@pytest.mark.parametrize("cfg", [FP32_VOC, MASKED],
                         ids=["default_audio", "masked_frames"])
def test_slp_chain_matches_jax(params, cfg):
    jp, tp = params
    audio, mask, text, bids, bmask = _inputs(1)
    max_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length)
    rng = np.random.default_rng(2)
    x_init = rng.standard_normal(
        (B, max_frames, cfg.dit.hidden_dim)).astype(np.float32)
    steps = rng.standard_normal(
        (cfg.sampler.num_steps,) + x_init.shape).astype(np.float32)
    jw, jframes, jlogits = jax.jit(functools.partial(_jax_slp_chain, cfg))(
        jp, jx(audio), jx(mask), jx(text), jx(bids), jx(bmask), jx(x_init),
        jx(steps))
    _check_no_near_tie(jlogits, 1e-5)
    fn = build_synthesize_with_slp(to_torch_cfg(cfg), byt5_cfg=TBYT5,
                                   device="cpu")
    tw, tframes = fn(tp, audio, mask, text, bids, bmask, init_noise=x_init,
                     step_noise=steps)
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    if cfg is MASKED:
        assert (np.asarray(jframes) < max_frames).all()
    assert tw.shape == jw.shape == (B, max_frames * cfg.codec.hop_length)
    np.testing.assert_allclose(np_of(tw), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)


def test_slp_chain_generator_draws_are_its_explicit_noise(params):
    """The generator draws x_init, then one draw per step: the same seed
    gives the same waveform, and replaying the draws as explicit noise
    gives it bit for bit. ``init_slp_params`` leaves the serving fields'
    draws as they were."""
    _, tp = params
    tcfg = to_torch_cfg(MASKED)
    audio, mask, text, bids, bmask = _inputs(3)
    fn = build_synthesize_with_slp(tcfg, byt5_cfg=TBYT5, device="cpu")
    w1, f1 = fn(tp, audio, mask, text, bids, bmask,
                torch.Generator().manual_seed(4))
    w2, f2 = fn(tp, audio, mask, text, bids, bmask,
                torch.Generator().manual_seed(4))
    assert torch.equal(w1, w2) and torch.equal(f1, f2)
    g = torch.Generator().manual_seed(4)
    shape = (B, 64, tcfg.dit.hidden_dim)
    init = torch.randn(shape, generator=g)
    steps = torch.stack([torch.randn(shape, generator=g)
                         for _ in range(tcfg.sampler.num_steps)])
    w3, f3 = fn(tp, audio, mask, text, bids, bmask, init_noise=init,
                step_noise=steps)
    assert torch.equal(w1, w3) and torch.equal(f1, f3)

    extra = init_slp_params(tcfg, seed=1, byt5_cfg=TBYT5)
    assert sorted(extra) == ["byt5", "slp"]
    tp2 = dataclasses.replace(tp, **extra)
    w4, _ = fn(tp2, audio, mask, text, bids, bmask,
               torch.Generator().manual_seed(4))
    assert torch.isfinite(w4).all() and w4.shape == w1.shape
