"""The port's SLP training against the JAX package at the tiny configs of
tests/test_pipeline.py: one ``build_slp_train_step`` step (loss, accuracy,
params, mu, nu) and ``eval_fn`` from the same state and batch, the
seeded trainable draw against JAX's init tree, and SLP train states
through ``.npz`` both ways.

Tolerances (max |port - JAX| over max |JAX|): loss 1e-5, mu and nu 1e-4,
accuracy exact, params 1e-5 of the flat vector's scale except the
attention's key bias. Its gradient is zero in exact arithmetic (softmax
does not move when one constant joins a row), so both packages compute
rounding noise (|g| ~ 1e-9), and Adam's g / (sqrt(g^2) + eps) divides it
by eps: each moves those elements by up to lr in a direction of its own,
and they are held to that bound. The codec's codebooks are set from the
fixture's latents (``varied_codebooks``), so the frames take several
codes.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.models import slp as jslp
from ditto_tts_tpu.text import byt5 as jbyt5
from ditto_tts_tpu.train import checkpoint as jckpt
from ditto_tts_tpu.train import steps as jsteps

from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import ByT5Config
from ditto_tts_tpu_torch.models import slp as tslp
from ditto_tts_tpu_torch.train import checkpoint as tckpt
from ditto_tts_tpu_torch.train import steps as tsteps

from _torch_port_util import (CFG, CODEC_CFG, jax_generator_params, jitter,
                              np_of, numpy_tree, to_torch_cfg, tt,
                              varied_codebooks)

BYT5 = jbyt5.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                        num_layers=1, num_heads=2)
TBYT5 = ByT5Config(**dataclasses.asdict(BYT5))
SLP_CFG = CFG.slp
B, L = 4, 256


def rel_err(got, want):
    got = np.asarray(np_of(got), np.float64)
    want = np.asarray(np_of(want), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=1)
def _fixtures():
    npt = numpy_tree(jax_generator_params())
    tc = to_torch_cfg(CFG)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((B, 1, L))).astype(np.float32)
    frozen = {"codec": varied_codebooks(npt["codec"], audio),
              "byt5": jitter(tparams.fill_spec(tparams.byt5_spec(TBYT5), 5),
                             6)}
    trainable = jitter(tparams.fill_spec(
        tparams.slp_spec(tc.slp, tc.codec.codebook_size), 7), 8)
    mask = np.ones((B, 9), np.int32)
    mask[2, 6:] = 0
    batch = {"audio": audio,
             "padding_mask": np.ones((B, L), np.int32),
             "text_ids": rng.integers(3, BYT5.vocab_size, (B, 9)).astype(
                 np.int32),
             "text_mask": mask,
             "label": np.asarray([0, 3, 10, 3], np.int32)}
    return frozen, trainable, batch


@functools.lru_cache(maxsize=1)
def _jax_step():
    init, step, evalf = jsteps.build_slp_train_step(
        SLP_CFG, CODEC_CFG, BYT5, learning_rate=LR)
    return init, jax.jit(step), jax.jit(evalf)


def _port_step():
    return tsteps.build_slp_train_step(
        to_torch_cfg(SLP_CFG), to_torch_cfg(CODEC_CFG), TBYT5,
        learning_rate=LR, device="cpu")


LR = 1e-2


def _key_bias(params):
    """A flat mask of the attention's key biases (rows h..2h of every
    ``in_proj_bias``), in ``ravel_tree`` order."""
    def mark(path, leaf):
        m = torch.zeros_like(leaf, dtype=torch.bool)
        if path.endswith("in_proj_bias"):
            h = leaf.shape[0] // 3
            m[h:2 * h] = True
        return m
    marks = [mark(p, leaf) for p, leaf in tparams.tree_leaves(params)]
    return torch.cat([m.reshape(-1) for m in marks])


def _assert_states_close(got, want):
    want = tparams.from_jax_train_state(want)
    steps = int(want["step"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == steps
    for key in ("mu", "nu"):
        assert rel_err(got["opt_state"][0][key],
                       want["opt_state"][0][key]) <= 1e-4, key
    a, _ = tparams.ravel_tree(got["params"])
    b, _ = tparams.ravel_tree(want["params"])
    kb = _key_bias(got["params"])
    scale = b.abs().max()
    assert (a - b)[~kb].abs().max() <= 1e-5 * scale
    # rounding noise: |mu| = |(1 - b1) g| far below eps, the step <= lr
    assert want["opt_state"][0]["mu"][kb].abs().max() < 1e-8
    assert (a - b)[kb].abs().max() <= 2 * steps * LR * (1 + 1e-6 * scale)


def test_slp_train_step_matches_jax():
    frozen, trainable, batch = _fixtures()
    jinit, jstep, jeval = _jax_step()
    jstate = jinit(_jtree(trainable))
    jnew, jm = jstep(jstate, _jtree(frozen), _jtree(batch))
    init, step, evalf = _port_step()
    tstate = init(tparams.tree_map(tt, trainable))
    tfrozen = tparams.tree_map(tt, frozen)
    tnew, tm = step(tstate, tfrozen, batch)
    assert sorted(tm) == ["accuracy", "loss"]
    assert rel_err(tm["loss"], jm["loss"]) <= 1e-5
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    _assert_states_close(tnew, jax.tree_util.tree_map(np.asarray, jnew))
    em, jem = evalf(tstate, tfrozen, batch), jeval(jstate, _jtree(frozen),
                                                   _jtree(batch))
    assert rel_err(em["loss"], jem["loss"]) <= 1e-5
    assert float(em["accuracy"]) == float(jem["accuracy"])


def test_slp_accuracy_takes_the_first_index_of_a_tie():
    """Two equal top logits: the first index is the prediction, as
    ``jnp.argmax`` decides (the length predictor's weights zeroed, its
    bias setting the tie)."""
    frozen, trainable, batch = _fixtures()
    head = trainable["length_predictor"]
    bias = np.zeros_like(head["bias"])
    bias[[3, 5]] = 1.0
    tied = dict(trainable, length_predictor={
        "weight": np.zeros_like(head["weight"]), "bias": bias})
    batch = dict(batch, label=np.asarray([3, 5, 3, 5], np.int32))
    _, _, jeval = _jax_step()
    init, _, evalf = _port_step()
    got = evalf(init(tparams.tree_map(tt, tied)),
                tparams.tree_map(tt, frozen), batch)
    want = jeval(_jax_step()[0](_jtree(tied)), _jtree(frozen), _jtree(batch))
    assert float(got["accuracy"]) == float(want["accuracy"]) == 0.5


def test_slp_train_states_cross_both_ways(tmp_path):
    frozen, trainable, batch = _fixtures()
    jinit, jstep, _ = _jax_step()
    j1, _ = jstep(jinit(_jtree(trainable)), _jtree(frozen), _jtree(batch))
    path = str(tmp_path / "SLP_epoch_1.npz")
    jckpt.save_checkpoint(path, j1)
    tc = to_torch_cfg(CFG)
    template = tparams.init_slp_train_state(tc.slp, tc.codec.codebook_size,
                                            seed=3, device="cpu")
    t1 = tckpt.restore_into(template, path)
    _, step, _ = _port_step()
    j2, _ = jstep(j1, _jtree(frozen), _jtree(batch))
    t2, _ = step(t1, tparams.tree_map(tt, frozen), batch)
    _assert_states_close(t2, jax.tree_util.tree_map(np.asarray, j2))
    back = str(tmp_path / "SLP_epoch_2.npz")
    tckpt.save_checkpoint(back, t2)
    # restored into JAX's template: the port's values, JAX's dtypes
    restored = jckpt.restore_into(j2, back)
    for (pa, a), (pb, b), (_, c) in zip(
            jax.tree_util.tree_flatten_with_path(restored)[0],
            jax.tree_util.tree_flatten_with_path(j2)[0],
            tparams.tree_leaves(t2)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), c.numpy())


@pytest.mark.parametrize("num_layers", [1, 2])
def test_slp_trainable_draw_has_the_jax_tree(num_layers):
    cfg = SLP_CFG.replace(num_layers=num_layers)
    got = tslp.init_slp_trainable(to_torch_cfg(cfg), 16, seed=1)
    want = jax.eval_shape(lambda k: jslp.init_slp_trainable(k, cfg, 16),
                          jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = ["".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                     for k in path) for path, _ in flat]
    assert [(p, tuple(t.shape)) for p, t in tparams.tree_leaves(got)] == [
        (n, w.shape) for n, (_, w) in zip(names, flat)]
    again = tparams.init_slp_train_state(to_torch_cfg(cfg), 16, seed=1,
                                         device="cpu")["params"]
    for (_, a), (_, b) in zip(tparams.tree_leaves(got),
                              tparams.tree_leaves(again)):
        assert torch.equal(a, b)
