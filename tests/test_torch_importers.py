"""The port's weight importers against the JAX package's, leaf for leaf and
bit for bit, on the same state dicts: BigVGAN (plain and weight-normed,
from the JAX package's torch oracle ``eval/torch_bigvgan.py``), the
reference DiTTo names, Speech2Text (a random-init ``transformers`` model)
and speechbrain's ECAPA (``eval/torch_ecapa.py``). Also the DiT's heads
wider than 128, which take the matmul-softmax math as JAX's dispatch does,
never kernel A."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.core.config import DiTConfig
from ditto_tts_tpu.eval.torch_bigvgan import build_bigvgan
from ditto_tts_tpu.eval.torch_ecapa import build_random_ecapa
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.models import ecapa as jecapa
from ditto_tts_tpu.models import s2t as js2t
from ditto_tts_tpu.models import vocoder as jvoc

from ditto_tts_tpu_torch.models import dit as tdit
from ditto_tts_tpu_torch.models import ecapa as tecapa
from ditto_tts_tpu_torch.models import s2t as ts2t
from ditto_tts_tpu_torch.models import vocoder as tvoc
from ditto_tts_tpu_torch.params import _dit_spec, fill_spec, tree_leaves

from _torch_port_util import VOC_CFG, jx, to_torch_cfg, tt


def assert_trees_bitwise(got, want):
    """Same paths (JAX's flatten order), shapes, dtypes and values."""
    g = list(tree_leaves(got))
    w = list(tree_leaves(jax.tree_util.tree_map(np.asarray, want)))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _bigvgan_sd():
    m = build_bigvgan(VOC_CFG, seed=3)
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


def test_bigvgan_import_matches_jax():
    sd = _bigvgan_sd()
    cfg = to_torch_cfg(VOC_CFG)
    got = tvoc.import_bigvgan_state_dict(sd, cfg)
    assert_trees_bitwise(got, jvoc.import_bigvgan_state_dict(sd, VOC_CFG))
    assert "bias" not in got["conv_post"]
    assert got["act_post"]["alpha"].ndim == 1
    # tensors in the state dict, as torch.load gives them
    got_t = tvoc.import_bigvgan_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert_trees_bitwise(got_t, jvoc.import_bigvgan_state_dict(sd, VOC_CFG))


def test_bigvgan_export_inverts_import():
    """export_bigvgan_state_dict gives BigVGAN's own names and values back,
    and importing its output gives the same tree bit for bit."""
    sd = _bigvgan_sd()
    cfg = to_torch_cfg(VOC_CFG)
    tree = tvoc.import_bigvgan_state_dict(sd, cfg)
    out = tvoc.export_bigvgan_state_dict(tree, cfg)
    assert set(out) <= set(sd)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy().reshape(sd[k].shape), sd[k],
                                      err_msg=k)
    assert_trees_bitwise(tvoc.import_bigvgan_state_dict(out, cfg), tree)


def test_bigvgan_import_folds_weight_norm_as_jax():
    sd = _bigvgan_sd()
    rng = np.random.default_rng(4)
    wn = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            base = k[:-len(".weight")]
            wn[base + ".weight_v"] = v
            wn[base + ".weight_g"] = rng.uniform(
                0.5, 2.0, (v.shape[0], 1, 1)).astype(np.float32)
        else:
            wn[k] = v
    got = tvoc.import_bigvgan_state_dict(wn, to_torch_cfg(VOC_CFG))
    want = jvoc.import_bigvgan_state_dict(wn, VOC_CFG)
    assert_trees_bitwise(got, want)
    # the fold is g * v / ||v||: each output channel's norm is g
    w = got["conv_pre"]["weight"].numpy()
    np.testing.assert_allclose(
        np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 2))),
        wn["conv_pre.weight_g"].ravel(), rtol=1e-5)


def _reference_dit_sd(cfg, seed):
    """A numpy state dict under the reference DiTTO's names, with its
    buffers and a frozen ``nac.*`` entry the importer must ignore."""
    tree = fill_spec(_dit_spec(to_torch_cfg(cfg)), seed)
    sd = {"t_embedding.weight": tree["t_embedding"]["weight"],
          "alphas_cumprod": np.linspace(1, 0, 10).astype(np.float32),
          "rotary.inv_freq": np.ones(3, np.float32),
          "nac.embedding_head.weight": np.zeros((4, 4), np.float32)}

    def lin(name, p):
        for k, v in p.items():
            sd[f"{name}.{k}"] = v

    lin("time_embed.0", tree["time_embed"]["fc1"])
    lin("time_embed.2", tree["time_embed"]["fc2"])
    lin("ada_ln.time_mlp.1", tree["ada_ln"]["time_mlp"])
    lin("ada_ln.text_mlp.1", tree["ada_ln"]["text_mlp"])
    lin("proj_in", tree["proj_in"])
    lin("proj_out", tree["proj_out"])
    for i, blk in enumerate(tree["blocks"]):
        for name in ("norm1", "norm2", "norm3", "mlp_fc1", "gate",
                     "mlp_fc2"):
            lin(f"blocks.{i}.{name}", blk[name])
        for name in ("attn", "cross_attn"):
            sd[f"blocks.{i}.{name}.in_proj_weight"] = \
                blk[name]["in_proj_weight"]
            sd[f"blocks.{i}.{name}.in_proj_bias"] = blk[name]["in_proj_bias"]
            lin(f"blocks.{i}.{name}.out_proj", blk[name]["out_proj"])
    return sd, tree


def test_reference_dit_import_matches_jax():
    cfg = DiTConfig(hidden_dim=12, num_layers=2, num_heads=2, time_dim=8,
                    text_dim=12, diffusion_steps=10, max_token_length=64)
    sd, tree = _reference_dit_sd(cfg, 5)
    got = tdit.import_reference_state_dict(sd, to_torch_cfg(cfg))
    want = jdit.import_reference_state_dict(sd, cfg)
    assert_trees_bitwise(got, want)
    # and it is the tree the names came from
    for (p, a), (_, b) in zip(tree_leaves(got), tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=p)


def test_dit_wide_heads_take_the_plain_math(monkeypatch):
    """A head wider than 128 (the reference's trained DiT has one head of
    768) never reaches ``attention`` (kernel A on the card, which raises
    for it), as JAX sends it to ``sdpa_reference``; the forward still
    matches JAX's. Heads of 128 or less keep ``attention``."""
    cfg = DiTConfig(hidden_dim=160, num_layers=1, num_heads=1, time_dim=8,
                    text_dim=160, diffusion_steps=10, max_token_length=64)
    tree = fill_spec(_dit_spec(to_torch_cfg(cfg)), 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 160)).astype(np.float32)
    text = rng.standard_normal((2, 5, 160)).astype(np.float32)
    t = np.array([3, 8])
    want = jdit.ditto_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                              cfg, jx(x), jx(text), jx(t))

    def refuse(*a, **k):
        raise AssertionError("kernel A's entry point called")

    monkeypatch.setattr(tdit, "attention", refuse)
    tp = jax.tree_util.tree_map(tt, tree)
    got = tdit.ditto_forward(tp, to_torch_cfg(cfg), tt(x), tt(text), tt(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    narrow = to_torch_cfg(cfg.replace(num_heads=2))
    with pytest.raises(AssertionError, match="kernel A"):
        tdit.ditto_forward(tp, narrow, tt(x), tt(text), tt(t))


S2T_CFG = js2t.S2TConfig(vocab_size=61, d_model=16, encoder_layers=2,
                         decoder_layers=2, encoder_heads=2, decoder_heads=2,
                         encoder_ffn=32, decoder_ffn=32, conv_channels=24,
                         input_features=12)


def test_s2t_hf_import_matches_jax():
    transformers = pytest.importorskip("transformers")
    c = S2T_CFG
    torch.manual_seed(0)
    hf = transformers.Speech2TextForConditionalGeneration(
        transformers.Speech2TextConfig(
            vocab_size=c.vocab_size, d_model=c.d_model,
            encoder_layers=c.encoder_layers,
            decoder_layers=c.decoder_layers,
            encoder_attention_heads=c.encoder_heads,
            decoder_attention_heads=c.decoder_heads,
            encoder_ffn_dim=c.encoder_ffn, decoder_ffn_dim=c.decoder_ffn,
            num_conv_layers=c.num_conv_layers,
            conv_channels=c.conv_channels,
            conv_kernel_sizes=[c.conv_kernel] * c.num_conv_layers,
            input_feat_per_channel=c.input_features)).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    tcfg = ts2t.S2TConfig(**c.__dict__)
    assert_trees_bitwise(ts2t.import_hf_state_dict(sd, tcfg),
                         js2t.import_hf_state_dict(sd, c))
    # a bare Speech2TextModel's names (no "model." prefix)
    bare = {k[len("model."):]: v for k, v in sd.items()
            if k.startswith("model.")}
    assert_trees_bitwise(ts2t.import_hf_state_dict(bare, tcfg),
                         js2t.import_hf_state_dict(bare, c))


def test_ecapa_speechbrain_import_matches_jax():
    sd = {k: v.detach().numpy()
          for k, v in build_random_ecapa(2).state_dict().items()}
    want = jecapa.import_speechbrain_state_dict(sd, jecapa.ECAPAConfig())
    got = tecapa.import_speechbrain_state_dict(sd, tecapa.ECAPAConfig())
    assert_trees_bitwise(got, want)
    pre = {"embedding_model." + k: v for k, v in sd.items()}
    assert_trees_bitwise(
        tecapa.import_speechbrain_state_dict(pre, tecapa.ECAPAConfig()), want)
