"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
numpy-seeded inputs go through the JAX function and its counterpart in
``ditto_tts_tpu_torch``; weights cross with ``from_jax_params``.

Importing this module sets the tests' CPU thread policy: one torch thread
in this process, and ``OMP_NUM_THREADS=1`` for every process a test
starts. The Tier-1 run's six xdist workers share the runner's cores, and
torch's per-core OpenMP pools spin-wait against each other: on 8 cores,
a file that takes 4.4 s alone took 715 s in the suite. xdist collects
every test module in every worker, so each worker imports this module
before its first test."""

import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.codec import encodec as codec_mod
from ditto_tts_tpu.core.config import (AudioConfig, CodecConfig, DiTConfig,
                                       NACConfig, PipelineConfig,
                                       SamplerConfig, SLPConfig,
                                       VocoderConfig)
from ditto_tts_tpu.infer.generator import GeneratorParams
from ditto_tts_tpu.models import dit as dit_mod
from ditto_tts_tpu.models import nac as nac_mod
from ditto_tts_tpu.models import vocoder as voc_mod
from ditto_tts_tpu.text import gpt2 as gpt2_mod

from ditto_tts_tpu_torch import config as tconfig
from ditto_tts_tpu_torch.params import (FIELDS, SLP_FIELDS, fill_spec,
                                        from_jax_params, generator_spec)

torch.set_num_threads(1)
os.environ["OMP_NUM_THREADS"] = "1"

# the tiny configs of tests/test_pipeline.py
HID = 12
CODEC_CFG = CodecConfig(num_filters=4, dimension=8, ratios=(2, 2, 2),
                        codebook_size=16, num_quantizers=4, lstm_layers=1)
DIT_CFG = DiTConfig(hidden_dim=HID, num_layers=1, num_heads=2, time_dim=8,
                    text_dim=HID, diffusion_steps=10, max_token_length=64)
VOC_CFG = VocoderConfig(num_mels=8, upsample_rates=(2, 2, 2),
                        upsample_kernel_sizes=(4, 4, 4),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3),),
                        n_fft=16, hop_size=8, win_size=16)
GPT2_CFG = gpt2_mod.GPT2Config(vocab_size=32, n_positions=64, n_embd=HID,
                               n_layer=1, n_head=2)
CFG = PipelineConfig(
    audio=AudioConfig(), codec=CODEC_CFG,
    nac=NACConfig(hidden_size=HID, codebook_size=16),
    slp=SLPConfig(embedding_dim=16, num_layers=1, num_heads=1),
    dit=DIT_CFG, vocoder=VOC_CFG, sampler=SamplerConfig(num_steps=4))


def to_torch_cfg(cfg):
    """The port's config equal to a JAX config (through their JSON)."""
    return getattr(tconfig, type(cfg).__name__).from_json(cfg.to_json())


def jax_generator_params(cfg=CFG, seed=0, gpt2_cfg=GPT2_CFG):
    """A JAX GeneratorParams with the JAX init trees' structure and shapes
    (test_torch_config_params.py pins them), its values drawn with numpy:
    running the JAX inits eagerly compiles every op and takes ~25 s."""
    spec = generator_spec(to_torch_cfg(cfg), gpt2_vocab=gpt2_cfg.vocab_size,
                          gpt2_positions=gpt2_cfg.n_positions,
                          gpt2_layers=gpt2_cfg.n_layer)
    arrays = fill_spec(spec, seed)
    return GeneratorParams(**{f: jax.tree_util.tree_map(jnp.asarray,
                                                        arrays[f])
                              for f in FIELDS})


def jax_init_params(cfg=CFG, seed=0, gpt2_cfg=GPT2_CFG):
    """The JAX package's own inits (for the shape check, under
    jax.eval_shape)."""
    keys = jax.random.split(jax.random.key(seed), 8)
    nac_tr = nac_mod.init_nac_trainable(keys[3], cfg.nac)
    return GeneratorParams(
        dit=dit_mod.init_ditto(keys[0], cfg.dit),
        codec=codec_mod.init_codec(keys[1], cfg.codec),
        gpt2=gpt2_mod.init_gpt2(keys[2], gpt2_cfg),
        embedding_head=nac_tr["embedding_head"],
        vector_quantizer=nac_tr["vector_quantizer"],
        vocoder=voc_mod.init_bigvgan(keys[4], cfg.vocoder))


def numpy_tree(jp):
    """JAX GeneratorParams -> {field: nested dicts/lists of numpy}, with
    ``byt5`` and ``slp`` when present."""
    return {f: jax.tree_util.tree_map(np.asarray, getattr(jp, f))
            for f in FIELDS + SLP_FIELDS if getattr(jp, f) is not None}


def jitter(tree, seed, scale=0.1):
    """Every numpy leaf plus scale * N(0, 1), so norms' ones and biases'
    zeros are not trivial in a parity test."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


def port_params(jp):
    return from_jax_params(numpy_tree(jp))


def jx(a):
    return jnp.asarray(np.asarray(a))


def tt(a):
    return torch.from_numpy(np.array(a, copy=True))


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def assert_close(got, want, *, rtol, atol):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def varied_codebooks(codec, audio, n_codes=4, tries=300):
    """``codec`` (a numpy tree) with ``n_codes`` entries of every RVQ
    codebook replaced by the random encoder's latents at frames of
    ``audio`` [B, 1, L]. At the tiny configs the random SEANet's latents
    barely move along time, so the N(0, 1) codebooks give every frame one
    code and the paths after the embedding head see one row. The frames
    are the draw (of ``tries``) whose nearest-entry scores have the widest
    smallest margin (~1e-3 of their scale), so no code is a near tie."""
    from ditto_tts_tpu.codec import seanet
    lat = np.asarray(seanet.encode(
        jax.tree_util.tree_map(jnp.asarray, codec["encoder"]), CODEC_CFG,
        jnp.asarray(audio)))                                # [B, D, T]
    frames = lat.transpose(0, 2, 1).reshape(-1, lat.shape[1])
    books = np.array(codec["quantizer"]["codebooks"], np.float32)
    slots = np.linspace(0, books.shape[1] - 1, n_codes).astype(int)
    rng = np.random.default_rng(1)
    best, best_margin = None, -1.0
    for _ in range(tries):
        cb = books[0].astype(np.float64)
        cb[slots] = frames[rng.choice(len(frames), n_codes, replace=False)]
        scores = 2 * frames @ cb.T - (cb ** 2).sum(axis=1)
        top = np.sort(scores, axis=1)
        margin = (top[:, -1] - top[:, -2]).min() / np.abs(scores).max()
        if margin > best_margin:
            best, best_margin = cb[slots], margin
    books[:, slots] = best
    return dict(codec, quantizer={"codebooks": books})
