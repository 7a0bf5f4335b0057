"""The port's NAC training path against the JAX package at the tiny
configs of tests/test_pipeline.py: GPT2's stack, LM head and shifted LM
loss (with a padding mask) and their gradient with respect to the input
embeddings, the straight-through VQ and its gradients, ``nac_forward`` in
both VQ modes, one ``build_nac_train_step`` step from the same state and
batch, NAC train states through ``.npz`` both ways, and the GPT2 and
EnCodec importers on random-init ``transformers`` state dicts.

Tolerances (max |port - JAX| over max |JAX|): GPT2 outputs and gradients
1e-5 (fp32); the VQ and NAC losses and gradients 1e-5; after one step the
loss and params 1e-5, mu and nu 1e-4. Indices (argmax over fp32 products)
and imported trees are exact.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.codec import encodec as jcodec
from ditto_tts_tpu.codec import rvq as jrvq
from ditto_tts_tpu.models import nac as jnac
from ditto_tts_tpu.text import gpt2 as jgpt2
from ditto_tts_tpu.train import checkpoint as jckpt
from ditto_tts_tpu.train import steps as jsteps

from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.codec import encodec as tcodec
from ditto_tts_tpu_torch.codec import rvq as trvq
from ditto_tts_tpu_torch.config import GPT2Config
from ditto_tts_tpu_torch.models import nac as tnac
from ditto_tts_tpu_torch.text import gpt2 as tgpt2
from ditto_tts_tpu_torch.train import checkpoint as tckpt
from ditto_tts_tpu_torch.train import steps as tsteps

from _torch_port_util import (CFG, CODEC_CFG, GPT2_CFG, jax_generator_params,
                              jitter, np_of, numpy_tree, to_torch_cfg, tt,
                              varied_codebooks)

TGPT2 = GPT2Config(**dataclasses.asdict(GPT2_CFG))
NAC_CFG = CFG.nac
B, L = 2, 256
T = L // CODEC_CFG.hop_length
N_TEXT = 40


def rel_err(got, want):
    got = np.asarray(np_of(got), np.float64)
    want = np.asarray(np_of(want), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return tparams.tree_map(tt, tree)


@functools.lru_cache(maxsize=1)
def _fixtures():
    """numpy trees (GPT2 and the trainables jittered so norms and the
    codebook are not trivial) and a batch whose text mask pads the last
    ids of the second utterance."""
    npt = numpy_tree(jax_generator_params())
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    frozen = {"codec": varied_codebooks(npt["codec"], audio),
              "gpt2": jitter(npt["gpt2"], 1, 0.05)}
    trainable = jitter({"embedding_head": npt["embedding_head"],
                        "vector_quantizer": npt["vector_quantizer"]}, 2)
    mask = np.ones((B, N_TEXT), np.int32)
    mask[1, 25:] = 0
    batch = {"audio": audio,
             "padding_mask": np.ones((B, L), np.int32),
             "text_ids": rng.integers(0, GPT2_CFG.vocab_size,
                                      (B, N_TEXT)).astype(np.int32),
             "text_mask": mask}
    return frozen, trainable, batch


# ---------------------------------------------------------------------------
# GPT2
# ---------------------------------------------------------------------------

def test_gpt2_logits_loss_and_input_gradient_match_jax():
    frozen, _, batch = _fixtures()
    gp = frozen["gpt2"]
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, T, GPT2_CFG.n_embd)).astype(np.float32)
    mask, labels = batch["text_mask"][:, :T], batch["text_ids"][:, :T]

    def jloss(e):
        return jgpt2.lm_loss(jgpt2.gpt2_logits(_jtree(gp), GPT2_CFG, e,
                                               jnp.asarray(mask)),
                             jnp.asarray(labels))

    jh = jgpt2.gpt2_hidden_states(_jtree(gp), GPT2_CFG, jnp.asarray(emb),
                                  jnp.asarray(mask))
    jl = jgpt2.gpt2_logits(_jtree(gp), GPT2_CFG, jnp.asarray(emb),
                           jnp.asarray(mask))
    jloss_v, jgrad = jax.value_and_grad(jloss)(jnp.asarray(emb))

    tp = _ttree(gp)
    te = tt(emb).requires_grad_()
    th = tgpt2.gpt2_hidden_states(tp, TGPT2, te, tt(mask))
    tl = tgpt2.gpt2_logits(tp, TGPT2, te, tt(mask))
    tloss = tgpt2.lm_loss(tl, tt(labels))
    (tgrad,) = torch.autograd.grad(tloss, te)
    assert tl.dtype == torch.float32 and tl.shape == (B, T, 32)
    assert rel_err(th, jh) <= 1e-5
    assert rel_err(tl, jl) <= 1e-5
    assert rel_err(tloss, jloss_v) <= 1e-5
    assert rel_err(tgrad, jgrad) <= 1e-5
    # the padding bias reaches the padded utterance: without the mask its
    # logits move
    free = tgpt2.gpt2_logits(tp, TGPT2, te.detach())
    assert torch.equal(free[0], tl[0].detach())
    assert not torch.allclose(free[1], tl[1].detach())


def test_gpt2_importer_matches_jax():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=50, n_positions=16, n_embd=16, n_layer=2, n_head=2))
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = jgpt2.GPT2Config(vocab_size=50, n_positions=16, n_embd=16,
                           n_layer=2, n_head=2)
    want = jgpt2.import_hf_state_dict(sd, cfg)
    got = tgpt2.import_hf_state_dict(
        sd, GPT2Config(**dataclasses.asdict(cfg)))
    _assert_trees_equal(got, want)
    # and the bare GPT2Model names (no "transformer." prefix)
    bare = {k[len("transformer."):]: v for k, v in sd.items()
            if k.startswith("transformer.")}
    _assert_trees_equal(tgpt2.import_hf_state_dict(
        bare, GPT2Config(**dataclasses.asdict(cfg))), want)


def _assert_trees_equal(got, want):
    want = list(jax.tree_util.tree_flatten_with_path(want)[0])
    got = list(tparams.tree_leaves(got))
    assert len(got) == len(want)
    for (path, g), (jpath, w) in zip(got, want):
        assert path == "".join(
            f"/{getattr(k, 'key', getattr(k, 'idx', k))}" for k in jpath)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=path)


def test_encodec_importer_matches_jax():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.EncodecModel(transformers.EncodecConfig())
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = jcodec.CodecConfig()
    want = jcodec.import_hf_state_dict(sd, cfg)
    got = tcodec.import_hf_state_dict(sd, to_torch_cfg(cfg))
    _assert_trees_equal(got, want)
    # the spec's shapes, so the importer fills the tree init_nac_frozen draws
    spec = tparams.init_nac_frozen(to_torch_cfg(cfg), GPT2Config(n_layer=1),
                                   device="cpu")["codec"]
    assert [(p, tuple(t.shape)) for p, t in tparams.tree_leaves(spec)] == \
        [(p, tuple(t.shape)) for p, t in tparams.tree_leaves(got)]


# ---------------------------------------------------------------------------
# the straight-through VQ
# ---------------------------------------------------------------------------

def test_vq_straight_through_and_its_gradients_match_jax():
    _, trainable, _ = _fixtures()
    vq = trainable["vector_quantizer"]
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((B, 1, T, CFG.nac.hidden_size)).astype(
        np.float32)
    r = rng.standard_normal(lat.shape).astype(np.float32)

    def jfn(cb, x):
        ste, _, losses = jrvq.vq_straight_through({"codebook": cb}, x)
        return jnp.sum(ste * r) + 3.0 * losses["codebook_loss"] + \
            5.0 * losses["commitment_loss"]

    jste, jidx, jlosses = jrvq.vq_straight_through(_jtree(vq),
                                                   jnp.asarray(lat))
    jg_cb, jg_x = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(vq["codebook"]),
                                                jnp.asarray(lat))

    cb, x = tt(vq["codebook"]).requires_grad_(), tt(lat).requires_grad_()
    ste, idx, losses = trvq.vq_straight_through({"codebook": cb}, x)
    total = (ste * tt(r)).sum() + 3.0 * losses["codebook_loss"] + \
        5.0 * losses["commitment_loss"]
    g_cb, g_x = torch.autograd.grad(total, (cb, x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert rel_err(ste, jste) <= 1e-6
    for k in ("codebook_loss", "commitment_loss"):
        assert rel_err(losses[k], jlosses[k]) <= 1e-5, k
    assert rel_err(g_cb, jg_cb) <= 1e-5
    assert rel_err(g_x, jg_x) <= 1e-5


def test_init_vector_quantizer_is_xavier_uniform():
    cb = trvq.init_vector_quantizer(64, 32, seed=3)["codebook"]
    bound = np.sqrt(6.0 / (64 + 32))
    assert cb.shape == (64, 32) and cb.dtype == torch.float32
    assert cb.abs().max() <= bound and cb.abs().max() > 0.9 * bound
    assert torch.equal(cb, trvq.init_vector_quantizer(64, 32, seed=3)[
        "codebook"])
    shapes = jax.eval_shape(lambda k: jrvq.init_vector_quantizer(k, 64, 32),
                            jax.random.key(0))
    assert shapes["codebook"].shape == tuple(cb.shape)


# ---------------------------------------------------------------------------
# nac_forward and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_compat", [False, True])
def test_nac_forward_matches_jax(ref_compat):
    frozen, trainable, batch = _fixtures()
    want = jnac.nac_forward(
        _jtree(trainable), _jtree(frozen["codec"]), _jtree(frozen["gpt2"]),
        NAC_CFG, CODEC_CFG, GPT2_CFG, jnp.asarray(batch["text_ids"]),
        jnp.asarray(batch["text_mask"]), jnp.asarray(batch["audio"]),
        jnp.asarray(batch["padding_mask"]), ref_compat=ref_compat)
    got = tnac.nac_forward(
        _ttree(trainable), _ttree(frozen["codec"]), _ttree(frozen["gpt2"]),
        to_torch_cfg(NAC_CFG), to_torch_cfg(CODEC_CFG), TGPT2,
        tt(batch["text_ids"]), tt(batch["text_mask"]), tt(batch["audio"]),
        tt(batch["padding_mask"]), ref_compat=ref_compat)
    assert sorted(got) == sorted(want)
    assert ("codebook_loss" in got) != ref_compat
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert rel_err(got[k], want[k]) <= 1e-5, k
    assert got["reconstructed_audio"].grad_fn is None


@functools.lru_cache(maxsize=2)
def _jax_step(ref_compat):
    init, step, evalf = jsteps.build_nac_train_step(
        NAC_CFG, CODEC_CFG, GPT2_CFG, ref_compat=ref_compat,
        learning_rate=1e-2)
    return init, jax.jit(step), jax.jit(evalf)


def _assert_states_close(got, want):
    want = tparams.from_jax_train_state(want)
    assert got["step"].dtype == torch.int32 and \
        int(got["step"]) == int(want["step"])
    assert int(got["opt_state"][0]["count"]) == \
        int(want["opt_state"][0]["count"])
    for key in ("mu", "nu"):
        assert rel_err(got["opt_state"][0][key],
                       want["opt_state"][0][key]) <= 1e-4, key
    for (pa, a), (_, b) in zip(tparams.tree_leaves(got["params"]),
                               tparams.tree_leaves(want["params"])):
        assert rel_err(a, b) <= 1e-5, pa


@pytest.mark.parametrize("ref_compat", [False, True])
def test_nac_train_step_matches_jax(ref_compat):
    frozen, trainable, batch = _fixtures()
    jinit, jstep, jeval = _jax_step(ref_compat)
    jstate = jinit(_jtree(trainable))
    jnew, jm = jstep(jstate, _jtree(frozen), _jtree(batch))

    init, step, evalf = tsteps.build_nac_train_step(
        to_torch_cfg(NAC_CFG), to_torch_cfg(CODEC_CFG), TGPT2,
        ref_compat=ref_compat, learning_rate=1e-2, device="cpu")
    tstate = init(_ttree(trainable))
    tfrozen = _ttree(frozen)
    tnew, tm = step(tstate, tfrozen, batch)     # a numpy batch, as data/
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert rel_err(tm[k], jm[k]) <= 1e-5, k
    _assert_states_close(tnew, jax.tree_util.tree_map(np.asarray, jnew))
    # ref_compat: no gradient reaches the codebook, so it only decays
    cb0 = tstate["params"]["vector_quantizer"]["codebook"]
    cb1 = tnew["params"]["vector_quantizer"]["codebook"]
    assert torch.allclose(cb1, cb0 * (1 - 1e-2 * 1e-6)) == ref_compat
    em = evalf(tstate, tfrozen, batch)
    for k, v in jeval(jstate, _jtree(frozen), _jtree(batch)).items():
        assert rel_err(em[k], v) <= 1e-5, k


def test_nac_train_states_cross_both_ways(tmp_path):
    """A JAX NAC state saved after a step restores into the port's
    template (the seeded init_nac_train_state) and steps as JAX does; a
    port state restores into JAX's template with JAX's keys and dtypes."""
    frozen, trainable, batch = _fixtures()
    jinit, jstep, _ = _jax_step(False)
    j1, _ = jstep(jinit(_jtree(trainable)), _jtree(frozen), _jtree(batch))
    path = str(tmp_path / "NAC_epoch_1.npz")
    jckpt.save_checkpoint(path, j1, metadata={"epoch": 1})
    template = tparams.init_nac_train_state(to_torch_cfg(NAC_CFG), seed=7,
                                            device="cpu")
    t1 = tckpt.restore_into(template, path)
    _, step, _ = tsteps.build_nac_train_step(
        to_torch_cfg(NAC_CFG), to_torch_cfg(CODEC_CFG), TGPT2,
        learning_rate=1e-2, device="cpu")
    j2, _ = jstep(j1, _jtree(frozen), _jtree(batch))
    t2, _ = step(t1, _ttree(frozen), batch)
    _assert_states_close(t2, jax.tree_util.tree_map(np.asarray, j2))

    back = str(tmp_path / "NAC_epoch_2.npz")
    tckpt.save_checkpoint(back, t2)
    restored = jckpt.restore_into(j2, back)
    with np.load(back) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype for k in a.files)
    # restored into JAX's template: the port's values, JAX's dtypes
    for (pa, a), (pb, b), (_, c) in zip(
            jax.tree_util.tree_flatten_with_path(restored)[0],
            jax.tree_util.tree_flatten_with_path(j2)[0],
            tparams.tree_leaves(t2)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), c.numpy())


def test_nac_trainable_draw_has_the_jax_tree():
    got = tnac.init_nac_trainable(to_torch_cfg(NAC_CFG), seed=1)
    want = jax.eval_shape(lambda k: jnac.init_nac_trainable(k, NAC_CFG),
                          jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(p, tuple(t.shape)) for p, t in tparams.tree_leaves(got)] == [
        ("".join(f"/{k.key}" for k in path), w.shape) for path, w in flat]
    # the same draw as the serving tree's NAC fields
    full = tparams.fill_spec(tparams.nac_trainable_spec(
        to_torch_cfg(NAC_CFG)), 1)
    assert np.array_equal(got["embedding_head"]["weight"].numpy(),
                          full["embedding_head"]["weight"])
