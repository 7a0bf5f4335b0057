"""The port's DDIM sampler and its serving entry points against the JAX
package, at the tiny configs of tests/test_pipeline.py.

Tolerances: the sampler 1e-4 of the trajectory's scale (the first reverse
step divides by sqrt(abar_t), which scales fp32 round-off, as in
test_torch_dit_sampler.py's DDPM case); the chains' waveforms 1e-4 with
the fp32 vocoder, as test_torch_pipeline.py holds the default chain; the
port's build_synthesize, pipelined and recorded forms bit for bit."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.diffusion import sampler as jsampler
from ditto_tts_tpu.diffusion import schedule as jschedule
from ditto_tts_tpu.infer import generator as jgen
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.text import gpt2 as jgpt2

from ditto_tts_tpu_torch.diffusion import sampler as tsampler
from ditto_tts_tpu_torch.diffusion import schedule as tschedule
from ditto_tts_tpu_torch.infer.generator import (
    build_stage_fns, build_synthesize, build_synthesize_pipelined,
    build_synthesize_recorded)
from ditto_tts_tpu_torch.models import dit as tdit

from _torch_port_util import (CFG, jax_generator_params, jx, np_of,
                              port_params, to_torch_cfg, tt)

FP32_VOC = CFG.replace(vocoder=CFG.vocoder.replace(
    compute_dtype="float32", carry_dtype="float32"))
B, L = 2, 256
T, H = L // CFG.codec.hop_length, CFG.dit.hidden_dim
K = CFG.sampler.num_steps


@pytest.fixture(scope="module")
def params():
    jp = jax_generator_params()
    return jp, port_params(jp)


def _dit_models(jp, tp, cfg, text_emb):
    def jmodel(x, t):
        return jdit.ditto_forward(jp.dit, cfg, x, jx(text_emb), t)

    def tmodel(x, t):
        return tdit.ditto_forward(tp.dit, to_torch_cfg(cfg), x, tt(text_emb),
                                  t)

    return jmodel, tmodel


def _ddim_pair(params, cfg, seed, **kw):
    jp, tp = params
    rng = np.random.default_rng(seed)
    x_init = rng.standard_normal((B, 8, H)).astype(np.float32)
    text_emb = rng.standard_normal((B, 5, H)).astype(np.float32)
    taus = jsampler.respaced_timesteps(cfg.diffusion_steps, K)
    jmodel, tmodel = _dit_models(jp, tp, cfg, text_emb)
    jsched = jschedule.NoiseSchedule.cosine(cfg.diffusion_steps)
    tsched = tschedule.NoiseSchedule.cosine(cfg.diffusion_steps)
    key = jax.random.key(seed)
    want = jax.jit(lambda x: jsampler.ddim_sample(
        jmodel, key, x, jsched, taus, **kw))(jx(x_init))
    # JAX's per-step noise, replayed (fold_in(key, i) draws each step)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), x_init.shape, jnp.float32))
        for i in range(len(taus))])
    got = tsampler.ddim_sample(tmodel, tt(x_init), tsched, taus,
                               noise_seq=tt(noise), **kw)
    return np_of(got), np.asarray(want)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("prediction_type", ["eps", "x0", "v"])
def test_ddim_sample_eta0_matches_jax(params, prediction_type, clip):
    cfg = CFG.dit.replace(prediction_type=prediction_type)
    got, want = _ddim_pair(params, cfg, 1, eta=0.0, clip_denoised=clip,
                           prediction_type=prediction_type)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_ddim_sample_eta1_matches_jax_sigma(params):
    """At eta = 1 the noise enters with JAX's sigma (sampler.py:156-158):
    the same draws give the same trajectory, which differs from eta = 0."""
    got, want = _ddim_pair(params, CFG.dit, 2, eta=1.0)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    got0, _ = _ddim_pair(params, CFG.dit, 2, eta=0.0)
    assert np.abs(got - got0).max() > 1e-2 * scale


def test_ddim_sigma_is_the_jax_formula():
    sched = tschedule.NoiseSchedule.cosine(CFG.dit.diffusion_steps)
    taus = tsampler.respaced_timesteps(CFG.dit.diffusion_steps, K)
    _, abar, abar_prev, _, _ = tsampler._respaced_coeffs(sched, taus)
    z = torch.ones(K, 1, 1)
    # eps = 0 and x = 0: each step returns sqrt(abar_p) * 0 + sigma * z
    seen = []

    def model(x, t):
        seen.append(x.clone())
        return torch.zeros_like(x)

    tsampler.ddim_sample(model, torch.zeros(1, 1), sched, taus, eta=1.0,
                         noise_seq=z)
    a, p = abar.numpy().astype(np.float64), abar_prev.numpy()
    sigma = np.sqrt((1 - p) / (1 - a)) * np.sqrt(1 - a / p)
    # the input of step i + 1 is x0 * sqrt(abar_p) + sigma_i (x0 of a zero
    # eps is x / sqrt(abar_t))
    x = 0.0
    for i in range(K - 1):
        x = x / np.sqrt(a[i]) * np.sqrt(p[i]) + sigma[i]
        np.testing.assert_allclose(seen[i + 1].item(), x, rtol=1e-5)


def _generator_noise(seed, steps):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, T, H), generator=g) for _ in range(2)] + [
        torch.stack([torch.randn((B, T, H), generator=g)
                     for _ in range(steps)])]


def _jax_ddim_chain(cfg, cond_by_audio, jp, audio, mask, text, pn, init):
    """JAX build_synthesize's body under sampler_kind="ddim" with the prompt
    and init noise given (at eta = 0 the sampler's own draws are scaled by
    sigma = 0)."""
    schedule = jschedule.NoiseSchedule.cosine(cfg.dit.diffusion_steps)
    taus = jsampler.respaced_timesteps(cfg.dit.diffusion_steps,
                                       cfg.sampler.num_steps)
    latents = jgen.encode_prompt_latents(jp, cfg, audio, mask)
    text_emb = jgpt2.embed_tokens(jp.gpt2, text[:, :cfg.dit.max_token_length])
    t_full = jnp.full((latents.shape[0],), cfg.dit.diffusion_steps - 1,
                      jnp.int32)
    noised = jschedule.q_sample(schedule, latents, t_full, pn,
                                ref_compat=cfg.dit.ref_compat)
    x_init = noised if cond_by_audio else init

    def model_fn(x, t):
        return jdit.ditto_forward(jp.dit, cfg.dit, x, text_emb, t)

    refined = jsampler.ddim_sample(model_fn, jax.random.key(0), x_init,
                                   schedule, taus, eta=cfg.sampler.ddim_eta,
                                   clip_denoised=cfg.sampler.clip_denoised,
                                   prediction_type=cfg.dit.prediction_type)
    return jgen.latents_to_waveform(jp, cfg, refined, audio.shape[-1],
                                    ref_exact_vq=cfg.dit.ref_compat)


def _chain_inputs(seed):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    return audio, np.ones((B, L), np.int32), rng.integers(0, 32, (B, 20))


@pytest.mark.parametrize("cond_by_audio", [False, True])
@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_build_synthesize_matches_jax(params, kind, cond_by_audio):
    """The port's build_synthesize draws the prompt noise, x_init and the
    sampler's noise from its generator; the same noise through the JAX
    chain (build_synthesize_recorded for DDPM, the build_synthesize body
    for DDIM) gives the same waveform."""
    jp, tp = params
    audio, mask, text = _chain_inputs(4)
    got = build_synthesize(to_torch_cfg(FP32_VOC), sampler_kind=kind,
                           cond_by_audio=cond_by_audio, device="cpu")(
        tp, audio, mask, text, torch.Generator().manual_seed(9))
    pn, init, steps = (a.numpy() for a in _generator_noise(9, K))
    if kind == "ddpm":
        want, _ = jax.jit(jgen.build_synthesize_recorded(
            FP32_VOC, cond_by_audio=cond_by_audio))(
            jp, jx(audio), jx(mask), jx(text), jx(pn),
            None if cond_by_audio else jx(init), jx(steps))
    else:
        want = jax.jit(functools.partial(_jax_ddim_chain, FP32_VOC,
                                         cond_by_audio))(
            jp, jx(audio), jx(mask), jx(text), jx(pn), jx(init))
    assert got.shape == want.shape
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_build_synthesize_is_the_pipelined_chain(params, kind):
    """One seed gives one waveform through build_synthesize, the pipelined
    serving path and the recorded form fed the generator's draws, and
    another seed another; the stage functions no longer refuse DDIM."""
    _, tp = params
    tcfg = to_torch_cfg(FP32_VOC)
    audio, mask, text = _chain_inputs(5)
    one = build_synthesize(tcfg, sampler_kind=kind, device="cpu")(
        tp, audio, mask, text, torch.Generator().manual_seed(3))
    two = build_synthesize_pipelined(tcfg, sampler_kind=kind, device="cpu")(
        tp, audio, mask, text, torch.Generator().manual_seed(3))
    assert torch.equal(one, two)
    rec = build_synthesize_recorded(tcfg, sampler_kind=kind, device="cpu",
                                    return_intermediates=False)(
        tp, audio, mask, text, *_generator_noise(3, K))
    assert torch.equal(one, rec)
    assert set(build_stage_fns(tcfg, sampler_kind=kind)) >= {
        "sampler", "refine_indices"}
    other = build_synthesize(tcfg, sampler_kind=kind, device="cpu")(
        tp, audio, mask, text, torch.Generator().manual_seed(4))
    assert not torch.equal(one, other)
