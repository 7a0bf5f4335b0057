"""The port's codec (SEANet, LSTM, RVQ, VQ), mel and BigVGAN against the
JAX package. BigVGAN runs at the fused widths with the JAX Pallas kernels
in interpret mode (ops.conv_pallas.FORCE_INTERPRET), i.e. the JAX default
path as the TPU runs it: the port repeats its fused act->conv edge
semantics, so the whole waveform is compared.

Tolerances: fp32 chains 1e-4 (codec, vocoder: deep conv stacks summed in
another order), mel 1e-4 in log space; the bf16 vocoder 5e-2 (bf16 carry
rounds at other places in the two frameworks). Codes and VQ indices are
compared exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.codec import encodec as jencodec
from ditto_tts_tpu.codec import rvq as jrvq
from ditto_tts_tpu.core.config import VocoderConfig
from ditto_tts_tpu.models import vocoder as jvoc
from ditto_tts_tpu.nn import lstm as jlstm
from ditto_tts_tpu.ops import conv_pallas as jcp
from ditto_tts_tpu.ops import mel as jmel

from ditto_tts_tpu_torch.codec import encodec as tencodec
from ditto_tts_tpu_torch.codec import rvq as trvq
from ditto_tts_tpu_torch.models import vocoder as tvoc
from ditto_tts_tpu_torch.nn import lstm as tlstm
from ditto_tts_tpu_torch.ops import mel as tmel
from ditto_tts_tpu_torch.params import _vocoder_spec, fill_spec, tree_map

from _torch_port_util import (CODEC_CFG, CFG, assert_close,
                              jax_generator_params, jx, numpy_tree,
                              to_torch_cfg, tt)


@pytest.fixture(scope="module")
def codec_params():
    arrays = numpy_tree(jax_generator_params())["codec"]
    return (tree_map(jnp.asarray, arrays), tree_map(tt, arrays))


def _audio(b, n, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, 1, n))).astype(np.float32)


def test_codec_encode_decode(codec_params):
    jp, tp = codec_params
    audio = _audio(2, 200, 0)
    mask = np.ones((2, 200), np.int32)
    mask[1, 150:] = 0
    want = jax.jit(jencodec.codec_encode, static_argnums=1)(
        jp, CODEC_CFG, jx(audio), jx(mask))
    got = tencodec.codec_encode(tp, to_torch_cfg(CODEC_CFG), tt(audio),
                                tt(mask))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wav_j = jax.jit(jencodec.codec_decode, static_argnums=(1, 3))(
        jp, CODEC_CFG, want, 190)
    wav_t = tencodec.codec_decode(tp, to_torch_cfg(CODEC_CFG), got,
                                  output_length=190)
    assert tuple(wav_t.shape) == wav_j.shape == (2, 1, 190)
    assert_close(wav_t, wav_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ref_exact", [False, True])
def test_vq_and_rvq(ref_exact):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 9, 12)).astype(np.float32)
    cb = rng.standard_normal((16, 12)).astype(np.float32)
    want = jrvq.vq_indices({"codebook": jx(cb)}, jx(x), ref_exact=ref_exact)
    got = trvq.vq_indices({"codebook": tt(cb)}, tt(x), ref_exact=ref_exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    books = rng.standard_normal((4, 16, 8)).astype(np.float32)
    lat = rng.standard_normal((2, 8, 11)).astype(np.float32)
    codes_j = jrvq.rvq_encode(jx(books), jx(lat), 3)
    codes_t = trvq.rvq_encode(tt(books), tt(lat), 3)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert_close(trvq.rvq_decode(tt(books), codes_t),
                 jrvq.rvq_decode(jx(books), codes_j), rtol=1e-6, atol=1e-6)


def test_lstm():
    rng = np.random.default_rng(2)
    layers = [{k: (0.3 * rng.standard_normal(s)).astype(np.float32)
               for k, s in (("weight_ih", (32, 6 if i == 0 else 8)),
                            ("weight_hh", (32, 8)), ("bias_ih", (32,)),
                            ("bias_hh", (32,)))} for i in range(2)]
    x = rng.standard_normal((13, 3, 6)).astype(np.float32)
    want = jlstm.lstm(tree_map(jnp.asarray, layers), jx(x))
    got = tlstm.lstm(tree_map(tt, layers), tt(x))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop,mels,fmax", [(1024, 256, 100, None),
                                                 (64, 16, 8, 6000)])
def test_mel(n_fft, hop, mels, fmax):
    wav = np.clip(_audio(2, 4000, 3)[:, 0] * 5, -1, 1)
    kw = dict(sample_rate=24000, n_fft=n_fft, num_mels=mels, hop=hop,
              win_size=n_fft, fmin=0, fmax=fmax)
    want = jmel.get_mel_spectrogram(jx(wav), **kw)
    got = tmel.get_mel_spectrogram(tt(wav), **kw)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, rtol=1e-4, atol=1e-4)


def _vocoder_case(cfg, seed, b, t):
    arrays = fill_spec(_vocoder_spec(to_torch_cfg(cfg)), seed)
    # nonzero snake params (the init leaves alpha = beta = 0), as the JAX
    # vocoder tests do
    arrays = tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, arrays)
    mel = np.random.default_rng(seed).standard_normal(
        (b, cfg.num_mels, t)).astype(np.float32)
    return tree_map(jnp.asarray, arrays), tree_map(tt, arrays), mel


@pytest.mark.parametrize("init_ch,kernels,dils", [
    (256, (3,), ((1, 3),)),            # widths 128 (fused) / 64
    (96, (3, 7), ((1, 3), (1, 3))),    # widths 48 / 24 (polyphase + conv)
])
def test_bigvgan_as_the_tpu_runs_it(monkeypatch, init_ch, kernels, dils):
    monkeypatch.setattr(jcp, "FORCE_INTERPRET", True)
    cfg = VocoderConfig(num_mels=8, upsample_rates=(2, 2),
                        upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=init_ch,
                        resblock_kernel_sizes=kernels,
                        resblock_dilation_sizes=dils,
                        compute_dtype="float32", carry_dtype="float32")
    jp, tp, mel = _vocoder_case(cfg, 7, 1, 48)
    want = jax.jit(jvoc.bigvgan_forward, static_argnums=1)(jp, cfg, jx(mel))
    got = tvoc.bigvgan_forward(tp, to_torch_cfg(cfg), tt(mel))
    assert tuple(got.shape) == want.shape == (1, 1, 48 * 4)
    assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bigvgan_bf16_default_dtypes():
    cfg = CFG.vocoder          # tiny widths, bf16 compute and carry
    jp, tp, mel = _vocoder_case(cfg, 8, 2, 20)
    want = jax.jit(jvoc.bigvgan_forward, static_argnums=1)(jp, cfg, jx(mel))
    got = tvoc.bigvgan_forward(tp, to_torch_cfg(cfg), tt(mel))
    assert got.dtype == torch.float32
    assert_close(got, want, rtol=5e-2, atol=5e-2)
