"""Three places where the port once computed another function than the JAX
package, each held against JAX:

  * the default vocoder's standalone activations (``aa_impl="fused_conv"``,
    ``layout="nlc"``) take the polynomial ``sin2`` wherever JAX sets
    ``fast`` (``models/vocoder.py:_act_nlc``, ``_amp_block_ncl`` and
    ``act_post``), and ``torch.sin`` elsewhere;
  * ``build_synthesize_recorded`` ignores ``cfg.sampler.clip_denoised``, as
    the JAX recorded form does;
  * ``build_stage_fns`` defaults ``ref_compat`` to False whatever
    ``cfg.dit.ref_compat`` says, as JAX does.

Tolerances: the activations at |alpha x| ~ 1e5, where ``sin2`` and
``torch.sin`` squared differ by ~1e-2, to 1e-5; the recorded chain as in
``tests/test_torch_pipeline.py`` (refined latents 1e-4 of their scale,
indices exactly); the stage functions' waveforms to 1e-5.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.codec import rvq as jrvq
from ditto_tts_tpu.core.config import VocoderConfig
from ditto_tts_tpu.infer import generator as jgen
from ditto_tts_tpu.models import vocoder as jvoc
from ditto_tts_tpu.ops import conv_pallas as jcp

from ditto_tts_tpu_torch.infer import generator as tgen
from ditto_tts_tpu_torch.models import vocoder as tvoc
from ditto_tts_tpu_torch.params import _vocoder_spec, fill_spec, tree_map

from _torch_port_util import (CFG, jax_generator_params, jx, np_of,
                              port_params, to_torch_cfg, tt)

FP32_VOC = VocoderConfig(compute_dtype="float32", carry_dtype="float32")


def _act_case(seed=0, c=8, t=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    # |alpha x| ~ 1e5: sin2's range reduction is no longer exact there
    p = {"alpha": np.full((c,), 12.0, np.float32),
         "beta": np.full((c,), -2.0, np.float32)}
    return x, p


@pytest.mark.parametrize("site", ["nlc_stage", "ncl_hybrid_and_act_post"])
def test_fused_conv_standalone_activation_takes_sin2(site):
    """F1: JAX's ``_act_nlc(..., "fused_conv")`` and ``_act(...,
    "polyphase", fast=True)`` (the NCL-hybrid AMP blocks and act_post)
    against the port's counterparts, at arguments where sin2 and sin^2
    differ."""
    x, p = _act_case()
    jp = {k: jx(v) for k, v in p.items()}
    tp = {k: tt(v) for k, v in p.items()}
    tcfg = to_torch_cfg(FP32_VOC)
    if site == "nlc_stage":
        want = np.asarray(jvoc._act_nlc(jx(x.transpose(0, 2, 1)), jp,
                                        FP32_VOC, "fused_conv"))
        want = want.transpose(0, 2, 1)
        got = tvoc._act_nlc(tt(x), tp, tcfg, "fused_conv")
    else:
        want = np.asarray(jvoc._act(jx(x), jp, FP32_VOC, "polyphase",
                                    fast=True))
        got = tvoc._act(tt(x), tp, tcfg, "polyphase", fast=True)
    exact = np.asarray(jvoc._act(jx(x), jp, FP32_VOC, "polyphase"))
    assert np.abs(exact - want).max() > 1e-3     # the case tells them apart
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=1e-5)


def _voc_cfg(init_ch, **kw):
    # num_mels 5 keeps these traces apart from other files' jit caches
    return VocoderConfig(num_mels=5, upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4),
                         upsample_initial_channel=init_ch,
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),),
                         compute_dtype="float32", carry_dtype="float32", **kw)


def _record_fast(monkeypatch, module):
    calls = []
    orig = module.snake_beta

    def rec(*a, fast=False, **kw):
        calls.append(bool(fast))
        return orig(*a, fast=fast, **kw)

    monkeypatch.setattr(module, "snake_beta", rec)
    return calls


@pytest.mark.parametrize("init_ch,layout,conv_impl,aa_impl", [
    (96, "nlc", "pallas", "fused_conv"),     # NCL-hybrid stages, act_post
    (96, "nlc", "gemm", "fused_conv"),       # NLC stages, NLC act_post
    (256, "nlc", "pallas", "fused_conv"),    # C pairs at 128, hybrid at 64
    (96, "ncl", "pallas", "fused_conv"),     # the exact polyphase form
    (96, "nlc", "pallas", "polyphase"),
])
def test_vocoder_sets_fast_where_jax_does(monkeypatch, init_ch, layout,
                                          conv_impl, aa_impl):
    """F1, the dispatch: the sequence of ``fast`` flags of every standalone
    snake in one forward equals JAX's, the JAX Pallas kernels in interpret
    mode (as the TPU dispatches)."""
    monkeypatch.setattr(jcp, "FORCE_INTERPRET", True)
    cfg = _voc_cfg(init_ch, layout=layout, conv_impl=conv_impl,
                   aa_impl=aa_impl)
    arrays = fill_spec(_vocoder_spec(to_torch_cfg(cfg)), 2)
    mel = np.random.default_rng(2).standard_normal((1, 5, 24)).astype(
        np.float32)
    jcalls = _record_fast(monkeypatch, jvoc)
    tcalls = _record_fast(monkeypatch, tvoc)
    # a fresh function object, so the jit traces (and records) anew
    jax.jit(lambda p, m: jvoc.bigvgan_forward(p, cfg, m))(
        tree_map(jx, arrays), jx(mel))
    tvoc.bigvgan_forward(tree_map(tt, arrays), to_torch_cfg(cfg), tt(mel))
    assert jcalls and tcalls == jcalls
    assert any(jcalls) == (aa_impl == "fused_conv" and layout == "nlc")


# ---------------------------------------------------------------------------
# F2, F3: the serving chain's builders
# ---------------------------------------------------------------------------

CLIP = CFG.replace(sampler=CFG.sampler.replace(clip_denoised=1.0),
                   vocoder=CFG.vocoder.replace(compute_dtype="float32",
                                               carry_dtype="float32"))
B, L = 2, 256
T, H = L // CFG.codec.hop_length, CFG.dit.hidden_dim


@pytest.fixture(scope="module")
def params():
    jp = jax_generator_params()
    return jp, port_params(jp)


def test_recorded_chain_ignores_clip_denoised(params):
    """F2: at ``clip_denoised=1.0`` the port's recorded chain is JAX's,
    which samples without the clip."""
    jp, tp = params
    rng = np.random.default_rng(4)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    text = rng.integers(0, 32, (B, 20))
    pn, init = (rng.standard_normal((B, T, H)).astype(np.float32)
                for _ in range(2))
    steps = rng.standard_normal((4, B, T, H)).astype(np.float32)
    jw, ji = jax.jit(jgen.build_synthesize_recorded(CLIP))(
        jp, jx(audio), jx(mask), jx(text), jx(pn), jx(init), jx(steps))
    tw, ti = tgen.build_synthesize_recorded(to_torch_cfg(CLIP),
                                            device="cpu")(
        tp, audio, mask, text, pn, init, steps)
    ref = np.asarray(ji["refined"])
    assert np.abs(ref).max() > 1.0     # a clip at 1 would have changed it
    np.testing.assert_allclose(np_of(ti["refined"]), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(np_of(ti["indices"]),
                                  np.asarray(ji["indices"]))
    np.testing.assert_allclose(np_of(tw), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)


def _near_tie(jp):
    """A codebook and latents where the reference's VQ expression (||x||^2
    - 2 x.c) + ||c||^2 rounds two entries to a tie that the default
    2 x.c - ||c||^2 separates: x = 1e4 u, entry 0 at the origin, entry 1 at
    1e-4 u (nearer), the rest far."""
    k, h = np.asarray(jp.vector_quantizer["codebook"]).shape
    u = np.zeros(h, np.float32)
    u[0] = 1.0
    cb = np.stack([np.zeros(h), 1e-4 * u]
                  + [-100.0 * (i + 1) * u for i in range(k - 2)]).astype(
                      np.float32)
    refined = np.broadcast_to(1e4 * u, (B, T, h)).astype(np.float32)
    return cb, refined


def test_stage_fns_default_ref_compat_is_false(params):
    """F3: with ``DiTConfig(ref_compat=True)``, ``build_stage_fns(cfg)``'s
    VQ is the default form, as JAX's (whose ``vq_decode`` stage and
    ``refine_indices`` default to ``ref_compat=False``)."""
    jp, tp = params
    cfg = CFG.replace(dit=CFG.dit.replace(ref_compat=True))
    cb, refined = _near_tie(jp)
    exact = np.asarray(jrvq.vq_indices({"codebook": jx(cb)}, jx(refined),
                                       ref_exact=True))
    default = np.asarray(jrvq.vq_indices({"codebook": jx(cb)},
                                         jx(refined)))
    assert (exact == 0).all() and (default == 1).all()
    jp = dataclasses.replace(jp, vector_quantizer={"codebook": jx(cb)})
    tp = dataclasses.replace(tp, vector_quantizer={"codebook": tt(cb)})
    want = np.asarray(jgen.build_stage_fns(cfg)["vq_decode"](
        jp, jx(refined), L))
    st = tgen.build_stage_fns(to_torch_cfg(cfg))
    with torch.inference_mode():
        idx = st["vq_indices"](tp, tt(refined))
        got = st["codec_decode"](tp, idx, L)
    assert (np_of(idx) == 1).all()
    np.testing.assert_allclose(np_of(got), want, rtol=1e-5, atol=1e-5)
