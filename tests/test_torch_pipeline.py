"""The port's whole serving chain against the JAX build_synthesize_recorded
at the tiny configs of tests/test_pipeline.py, with shared numpy noise and
every intermediate compared; and the port's serving entry point against
its own recorded form.

Tolerances: encoder latents, codes and VQ indices exactly; the DiT chain
1e-4 relative to the latents' scale (4 reverse steps amplify fp32
round-off by up to 1/sqrt(alpha_t)); codec waveform, mel and the fp32
vocoder 1e-4; the default bf16 vocoder 5e-2."""

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.infer.generator import \
    build_synthesize_recorded as jax_recorded

from ditto_tts_tpu_torch.infer.generator import (
    build_stage_fns, build_synthesize_pipelined, build_synthesize_recorded)

from _torch_port_util import (CFG, jax_generator_params, jx, np_of,
                              port_params, to_torch_cfg)

FP32_VOC = CFG.replace(vocoder=CFG.vocoder.replace(
    compute_dtype="float32", carry_dtype="float32"))
B, L = 2, 256
T, H = L // CFG.codec.hop_length, CFG.dit.hidden_dim


@pytest.fixture(scope="module")
def params():
    jp = jax_generator_params()
    return jp, port_params(jp)


def _inputs(seed, steps=4):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    text = rng.integers(0, 32, (B, 20))
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in ((B, T, H), (B, T, H), (steps, B, T, H))]
    return audio, mask, text, noise


def _compare(ji, ti, jw, tw, voc_tol):
    np.testing.assert_array_equal(np_of(ti["indices"]),
                                  np.asarray(ji["indices"]))
    for k in ("latents", "noised"):
        np.testing.assert_allclose(np_of(ti[k]), np.asarray(ji[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    ref = np.asarray(ji["refined"])
    np.testing.assert_allclose(np_of(ti["refined"]), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max(),
                               err_msg="refined")
    for k in ("codec_wav", "mel"):
        np.testing.assert_allclose(np_of(ti[k]), np.asarray(ji[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert tw.shape == jw.shape
    np.testing.assert_allclose(np_of(tw), np.asarray(jw), rtol=voc_tol,
                               atol=voc_tol, err_msg="waveform")


@pytest.mark.parametrize("cfg,ref_compat,cond_by_audio,voc_tol", [
    (FP32_VOC, False, False, 1e-4),
    (FP32_VOC, True, True, 1e-4),
    (CFG, False, False, 5e-2),
], ids=["fp32", "ref_compat_cond_by_audio", "bf16_vocoder"])
def test_recorded_chain_matches_jax(params, cfg, ref_compat, cond_by_audio,
                                    voc_tol):
    jp, tp = params
    audio, mask, text, (pn, init, steps) = _inputs(0)
    jfn = jax.jit(jax_recorded(cfg, ref_compat=ref_compat,
                               cond_by_audio=cond_by_audio))
    jw, ji = jfn(jp, jx(audio), jx(mask), jx(text), jx(pn),
                 None if cond_by_audio else jx(init), jx(steps))
    tfn = build_synthesize_recorded(to_torch_cfg(cfg), ref_compat=ref_compat,
                                    cond_by_audio=cond_by_audio,
                                    device="cpu")
    tw, ti = tfn(tp, audio, mask, text, pn,
                 None if cond_by_audio else init, steps)
    _compare(ji, ti, jw, tw, voc_tol)


def test_pipelined_is_the_recorded_chain_with_generator_noise(params):
    """The serving entry point draws the init noise, then one draw per
    step, from the generator: replaying those draws through the recorded
    form gives the same waveform, and the same seed gives the same
    waveform."""
    _, tp = params
    tcfg = to_torch_cfg(FP32_VOC)
    audio, mask, text, _ = _inputs(1)
    serve = build_synthesize_pipelined(tcfg, device="cpu")
    w1 = serve(tp, audio, mask, text, torch.Generator().manual_seed(11))
    w2 = serve(tp, audio, mask, text, torch.Generator().manual_seed(11))
    w3 = serve(tp, audio, mask, text, torch.Generator().manual_seed(12))
    assert torch.equal(w1, w2)
    assert not torch.equal(w1, w3)
    assert torch.isfinite(w1).all() and w1.abs().max() <= 1.0

    g = torch.Generator().manual_seed(11)
    init = torch.randn((B, T, H), generator=g)
    steps = torch.stack([torch.randn((B, T, H), generator=g)
                         for _ in range(tcfg.sampler.num_steps)])
    rec = build_synthesize_recorded(tcfg, device="cpu",
                                    return_intermediates=False)
    w4 = rec(tp, audio, mask, text, torch.zeros(B, T, H), init, steps)
    torch.testing.assert_close(w4, w1, rtol=0, atol=0)


def test_stage_fns_compose_to_the_serving_path(params):
    _, tp = params
    tcfg = to_torch_cfg(FP32_VOC)
    audio, mask, text, _ = _inputs(2)
    st = build_stage_fns(tcfg)
    a, m, t = torch.from_numpy(audio), torch.from_numpy(mask), \
        torch.from_numpy(text)
    with torch.inference_mode():
        lat = st["encode"](tp, a, m)
        ref = st["sampler"](tp, lat, t, torch.Generator().manual_seed(3))
        idx = st["vq_indices"](tp, ref)
        wav = st["codec_decode"](tp, idx, L)
        out = st["vocoder"](tp, st["mel"](tp, wav))
        idx2 = st["refine_indices"](tp, a, m, t,
                                    torch.Generator().manual_seed(3))
        out2 = st["indices_to_waveform"](tp, idx2, L)
    assert torch.equal(idx, idx2)
    assert torch.equal(out, out2)
    assert out.shape[0] == B and out.dim() == 2
