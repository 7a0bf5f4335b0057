"""The port's BigVGAN against the JAX package in every cell of its
``aa_impl`` x ``layout`` dispatch, as the TPU runs it: the JAX Pallas
kernels in interpret mode (``ops.conv_pallas.FORCE_INTERPRET`` and an
interpret-mode ``fused_snake_pallas``, which ``models/vocoder.py:_act``
imports at call time). Each case compares the whole waveform, edges
included; a cell where the JAX package raises NotImplementedError is
compared as that error, message and all.

Geometry: ``upsample_initial_channel=256`` gives an NLC stage at 128
channels and an NCL-hybrid stage at 64; 96 gives two NCL-hybrid stages at
48 and 24 (the widths of BigVGAN's last two stages). Tolerance: fp32
compute and carry, 1e-4 absolute and relative (deep conv stacks summed in
another order; the port's fused kernels take the JAX fused kernels'
polynomial sin^2, its polyphase and composed forms ``torch.sin``, within
5e-7 of it).
"""

import functools
import re

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.core.config import VocoderConfig
from ditto_tts_tpu.models import vocoder as jvoc
from ditto_tts_tpu.ops import conv_pallas as jcp
from ditto_tts_tpu.ops import fir_gemm as jfg
from ditto_tts_tpu.ops import snake_pallas as jsp

from ditto_tts_tpu_torch.models import vocoder as tvoc
from ditto_tts_tpu_torch.params import _vocoder_spec, fill_spec, tree_map

from _torch_port_util import assert_close, jx, to_torch_cfg, tt

IMPLS = ("fused_conv", "polyphase", "polyphase_gemm", "composed",
         "fused_pallas", "fused_ncl")


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The JAX vocoder's Pallas dispatch, run in interpret mode. The JAX
    band matrices of ``polyphase_gemm`` (``ops/fir_gemm.py:_band_matrix``,
    an lru_cache) that this file's jit traces make are tracers: the cache
    is emptied after each test, so no later eager call in the process (as
    ``tests/test_snake_resample.py`` makes) is handed one."""
    monkeypatch.setattr(jcp, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsp, "fused_snake_pallas", functools.partial(
        jsp.fused_snake_pallas, interpret=True))
    yield
    jfg._band_matrix.cache_clear()


def _cfg(init_ch, **kw):
    # num_mels 6 keeps these traces apart from other files' jit caches
    return VocoderConfig(num_mels=6, upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4),
                         upsample_initial_channel=init_ch,
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),),
                         compute_dtype="float32", carry_dtype="float32", **kw)


@functools.lru_cache(maxsize=4)
def _case(init_ch, seed=3, t=40):
    arrays = fill_spec(_vocoder_spec(to_torch_cfg(_cfg(init_ch))), seed)
    # nonzero snake params (the init leaves alpha = beta = 0), as the JAX
    # vocoder tests do
    arrays = tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, arrays)
    mel = np.random.default_rng(seed).standard_normal(
        (1, 6, t)).astype(np.float32)
    return arrays, mel


def _jax(cfg, init_ch):
    arrays, mel = _case(init_ch)
    return jax.jit(jvoc.bigvgan_forward, static_argnums=1)(
        tree_map(jx, arrays), cfg, jx(mel))


def _port(cfg, init_ch):
    arrays, mel = _case(init_ch)
    return tvoc.bigvgan_forward(tree_map(tt, arrays), to_torch_cfg(cfg),
                                tt(mel))


@pytest.mark.parametrize("layout,aa_impl", [("ncl", "fused_conv"),
                                            ("nlc", "polyphase")])
def test_vocoder_follows_layout_and_aa_impl(tpu_dispatch, layout, aa_impl):
    """At width 128 the JAX package runs the exact polyphase activation in
    both settings; a port that ran kernel C there differs at the edges."""
    cfg = _cfg(256, aa_impl=aa_impl, layout=layout)
    want = _jax(cfg, 256)
    got = _port(cfg, 256)
    assert tuple(got.shape) == want.shape == (1, 1, 160)
    assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init_ch,layout,conv_impl,aa_impl", [
    *[(256, lay, "pallas", impl) for lay in ("ncl", "nlc") for impl in IMPLS
      if (lay, impl) not in (("ncl", "fused_conv"), ("nlc", "polyphase"))],
    *[(96, "nlc", "pallas", impl) for impl in ("fused_pallas", "fused_ncl")],
    *[(96, "nlc", "gemm", impl) for impl in ("fused_pallas", "fused_ncl")],
])
def test_vocoder_dispatch_cell(tpu_dispatch, init_ch, layout, conv_impl,
                               aa_impl):
    cfg = _cfg(init_ch, aa_impl=aa_impl, layout=layout, conv_impl=conv_impl)
    try:
        want = _jax(cfg, init_ch)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError, match=re.escape(str(e))):
            _port(cfg, init_ch)
        return
    got = _port(cfg, init_ch)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_default_vocoder_sends_55_activations_to_polyphase_snake(
        monkeypatch):
    """At BigVGAN's published widths under the default setting
    (``fused_conv``, ``nlc``, ``pallas``), the standalone activations that
    kernel D runs on the card: 18 at 768 channels, 18 at 48, 18 at 24 and
    act_post, each with ``sin2``; none at 96-384, where kernel C's pairs
    run (6 mel frames keep every pair above C's short-sequence gate)."""
    from ditto_tts_tpu_torch.config import VocoderConfig as TVocoderConfig
    from ditto_tts_tpu_torch.ops import act_conv as tac
    cfg = TVocoderConfig()
    assert (cfg.aa_impl, cfg.layout, cfg.conv_impl) == (
        "fused_conv", "nlc", "pallas")
    calls, unfused = [], []

    def logged(into, fn):
        def call(x, alpha, beta=None, *, logscale=True, fast=False):
            into.append((x.shape[1], fast))
            return fn(x, alpha, beta, logscale=logscale, fast=fast)
        return call

    monkeypatch.setattr(tvoc, "polyphase_snake",
                        logged(calls, tvoc.polyphase_snake))
    monkeypatch.setattr(tac, "polyphase_snake",
                        logged(unfused, tac.polyphase_snake))
    params = tree_map(tt, fill_spec(_vocoder_spec(cfg), 0))
    mel = tt(np.random.default_rng(0).standard_normal(
        (1, cfg.num_mels, 6)).astype(np.float32))
    with torch.no_grad():
        wav = tvoc.bigvgan_forward(params, cfg, mel)
    assert tuple(wav.shape) == (1, 1, 6 * 256)
    assert unfused == []
    widths = [c for c, _ in calls]
    assert len(calls) == 55 and all(fast for _, fast in calls)
    assert {c: widths.count(c) for c in set(widths)} == {768: 18, 48: 18,
                                                         24: 19}
    assert widths[-1] == 24   # act_post

