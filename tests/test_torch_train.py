"""The port's DiTTo training against the JAX package at the tiny configs of
tests/test_pipeline.py: kernel A's gradient (the JAX ``_pallas_attn_bwd``
and ``jax.vjp`` of ``sdpa_reference``), flat and per-leaf AdamW against
optax, one train step from the same state, batch, t and noise, cross-
attention dropout and rematerialization, checkpoints that cross both ways,
``Trainer.fit``, and the grad guard of kernels B, C and D.

Tolerances (max |port - JAX| over max |JAX|): attention gradients 1e-5 in
fp32, 1e-2 in bf16; AdamW 1e-6; the train step's loss, mu, nu and params
1e-5 with fp32 DiT compute, 1e-2 with bf16 (cross-attention dropout 0: the
JAX RBG mask cannot be replayed). Rematerialized gradients equal the
stored ones to 1e-6.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.ops import attention as jattn
from ditto_tts_tpu.train import checkpoint as jckpt
from ditto_tts_tpu.train import steps as jsteps

from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import GPT2Config
from ditto_tts_tpu_torch.models import dit as tdit
from ditto_tts_tpu_torch.ops.attention import attention, attention_backward
from ditto_tts_tpu_torch.train import checkpoint as tckpt
from ditto_tts_tpu_torch.train import steps as tsteps
from ditto_tts_tpu_torch.train.trainer import Trainer

from _torch_port_util import (CODEC_CFG, DIT_CFG, GPT2_CFG,
                              jax_generator_params, jitter, jx, np_of,
                              numpy_tree, to_torch_cfg, tt)


def rel_err(got, want):
    got, want = np_of(got).astype(np.float64), np.asarray(
        np_of(want), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# kernel A's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None),
                                           (False, 11), (True, 11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_gradient_matches_jax(dtype, causal, kv_len):
    """The port's backward (and autograd through ``attention``) against
    JAX ``_pallas_attn_bwd`` called directly and ``jax.vjp`` of
    ``sdpa_reference``; a kv_len short of Sk is JAX's gradient over the
    first kv_len keys, zero past them."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 3, n, 8)).astype(np.float32)
               for n in (12, 16, 16))
    g = rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    kvl = 16 if kv_len is None else kv_len
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k[:, :, :kvl],
                                                    v[:, :, :kvl], g))
    want = jattn._pallas_attn_bwd(causal, None, (jq, jk, jv), jg)
    _, vjp = jax.vjp(lambda a, b, c: jattn.sdpa_reference(
        a, b, c, causal=causal), jq, jk, jv)
    want_vjp = vjp(jg)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    direct = attention_backward(tq.detach(), tk.detach(), tv.detach(),
                                torch.from_numpy(g).to(tdt), causal=causal,
                                kv_len=kv_len)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for i, name in enumerate("qkv"):
        assert auto[i].dtype == tdt and torch.equal(auto[i], direct[i])
        got = np_of(auto[i])
        if name != "q":
            assert not got[:, :, kvl:].any()       # no gradient past kv_len
            got = got[:, :, :kvl]
        assert rel_err(got, want[i]) <= tol, name
        assert rel_err(got, want_vjp[i]) <= tol, name


def test_attention_function_gradcheck():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, n, 4, generator=gen, dtype=torch.float64,
                           requires_grad=True) for n in (5, 7, 7))
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention(a, b, c, causal=True, kv_len=6),
        (q, k, v))


def test_attention_without_grad_is_the_plain_call():
    """No grad mode, or no operand that requires grad: no autograd node."""
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    with torch.no_grad():
        assert attention(q, q, q).grad_fn is None
    assert attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    assert attention(q, q, q).grad_fn is not None


def test_cuda_kernels_without_backward_refuse_grad():
    """The rule kernels B, C and D apply before launching: an input that
    requires grad under grad mode raises (their card cases are in
    tests/test_torch_cuda_kernels.py)."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.forbid_grad("conv1d", x, None)
    with torch.no_grad():
        kernels.forbid_grad("conv1d", x)
    kernels.forbid_grad("snake", x.detach(), None)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flat", [True, False])
def test_adamw_matches_optax(flat):
    rng = np.random.default_rng(1)
    params = {"b": [rng.standard_normal((3, 2)).astype(np.float32)],
              "a": rng.standard_normal((4,)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(3)]
    jtx = jsteps.make_adamw(1e-2, 1e-2, flat=flat)
    topt = tsteps.make_adamw(1e-2, 1e-2, flat=flat)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jtx.init(jp)
    tp = tparams.tree_map(tt, params)
    tst = topt.init(tp)
    for g in grads:
        upd, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst,
                              jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        tp, tst = topt.update(tparams.tree_map(tt, g), tst, tp)
    for (_, a), (_, b) in zip(tparams.tree_leaves(tp),
                              tparams.tree_leaves(numpy_tree_of(jp))):
        assert rel_err(a, b) <= 1e-6
    want = tparams.from_jax_train_state(
        {"params": {}, "opt_state": jax.tree_util.tree_map(np.asarray, jst),
         "step": np.int32(0)})["opt_state"]
    assert tst[0]["count"].dtype == torch.int32 and \
        int(tst[0]["count"]) == 3
    for key in ("mu", "nu"):
        for (_, a), (_, b) in zip(tparams.tree_leaves(tst[0][key]),
                                  tparams.tree_leaves(want[0][key])):
            assert rel_err(a, b) <= 1e-6


def numpy_tree_of(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# one DiTTo train step against JAX
# ---------------------------------------------------------------------------

B, L = 2, 256
T = L // CODEC_CFG.hop_length
TGPT2 = GPT2Config(**dataclasses.asdict(GPT2_CFG))


@functools.lru_cache(maxsize=1)
def _fixtures():
    npt = numpy_tree(jax_generator_params())
    dit = jitter(npt["dit"], 3)
    frozen = {"codec": npt["codec"], "gpt2": {"wte": npt["gpt2"]["wte"]},
              "embedding_head": npt["embedding_head"]}
    rng = np.random.default_rng(0)
    audio = {"audio": (0.1 * rng.standard_normal((B, 1, L))).astype(
                 np.float32),
             "padding_mask": np.ones((B, L), np.int32),
             "text_ids": rng.integers(0, 32, (B, 40)).astype(np.int32)}
    latents = {"latents": rng.standard_normal(
                   (B, T, DIT_CFG.hidden_dim)).astype(np.float32),
               "text_ids": audio["text_ids"]}
    return dit, frozen, {"audio": audio, "latents": latents}


@functools.lru_cache(maxsize=8)
def _jax_step(cfg, encode_dtype):
    init, step, _ = jsteps.build_ditto_train_step(
        cfg, CODEC_CFG, GPT2_CFG, learning_rate=1e-4,
        encode_dtype=encode_dtype)
    return init, jax.jit(step)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_step(cfg, encode_dtype):
    return tsteps.build_ditto_train_step(
        to_torch_cfg(cfg), to_torch_cfg(CODEC_CFG), TGPT2,
        learning_rate=1e-4, encode_dtype=encode_dtype, device="cpu")


def _jax_draws(key, cfg, n_frames):
    """t and the noise as the JAX loss draws them (split(key, 3))."""
    k_t, k_n, _ = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (B,), 0, cfg.diffusion_steps)
    noise = jax.random.normal(k_n, (B, n_frames, cfg.hidden_dim),
                              jnp.float32)
    return tt(t), tt(noise)


def _assert_states_close(got, want, tol):
    """got: the port's state; want: a JAX state (as numpy)."""
    want = tparams.from_jax_train_state(want)
    assert got["step"].dtype == torch.int32 and \
        int(got["step"]) == int(want["step"])
    assert int(got["opt_state"][0]["count"]) == \
        int(want["opt_state"][0]["count"])
    for key in ("mu", "nu"):
        assert rel_err(got["opt_state"][0][key],
                       want["opt_state"][0][key]) <= tol, key
    a, _ = tparams.ravel_tree(got["params"])
    b, _ = tparams.ravel_tree(want["params"])
    assert rel_err(a, b) <= tol


@pytest.mark.parametrize("pred,path,compute,encode,ref_compat", [
    ("eps", "latents", "float32", "float32", False),
    ("v", "audio", "float32", "float32", False),
    ("x0", "latents", "bfloat16", "float32", False),
    ("eps", "audio", "float32", "bfloat16", True),
    ("eps", "audio", "bfloat16", "float32", False),
])
def test_train_step_matches_jax(pred, path, compute, encode, ref_compat):
    dit, frozen, batches = _fixtures()
    cfg = DIT_CFG.replace(prediction_type=pred, compute_dtype=compute,
                          ref_compat=ref_compat, cross_attn_dropout=0.0)
    batch = batches[path]
    jinit, jstep = _jax_step(cfg, encode)
    jstate = jinit(_jtree(dit))
    key = jax.random.key(5)
    jnew, jm = jstep(jstate, _jtree(frozen), _jtree(batch), key)
    t, noise = _jax_draws(key, cfg, T)

    _, tstep, teval = _port_step(cfg, encode)
    tstate = tparams.from_jax_train_state(numpy_tree_of(jstate))
    tfrozen = tparams.tree_map(tt, frozen)
    tbatch = {k: tt(v) for k, v in batch.items()}
    tnew, tm = tstep(tstate, tfrozen, tbatch, t=t, noise=noise)
    tol = 1e-5 if compute == "float32" else 1e-2
    assert rel_err(tm["loss"], jm["loss"]) <= tol
    _assert_states_close(tnew, numpy_tree_of(jnew), tol)
    # eval: the same loss without a step
    assert rel_err(teval(tstate, tfrozen, tbatch, t=t, noise=noise)["loss"],
                   jm["loss"]) <= tol


# ---------------------------------------------------------------------------
# dropout and rematerialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["output", "probs"])
def test_dropout_keeps_one_minus_rate_and_scales(mode):
    cfg = to_torch_cfg(DIT_CFG.replace(attn_dropout_mode=mode,
                                       cross_attn_dropout=0.1))
    gen = torch.Generator().manual_seed(0)
    keeps = tdit.draw_keep_masks(cfg, gen, 4, 64, 48, "cpu")
    assert len(keeps) == cfg.num_layers
    want = (4, 64, cfg.hidden_dim) if mode == "output" else \
        (4, cfg.num_heads, 64, 48)
    assert tuple(keeps[0].shape) == want
    share = keeps[0].float().mean().item()
    assert abs(share - 0.9) < 0.01, share
    x = torch.full(want, 2.0)
    y = tdit._inverted(x, keeps[0], 0.1)
    assert torch.equal(y[keeps[0]], torch.full_like(y[keeps[0]], 2.0 / 0.9))
    assert not y[~keeps[0]].any()


def _dit_grads(cfg, dit, seed):
    params = tparams.tree_map(lambda a: tt(a).requires_grad_(), dit)
    rng = np.random.default_rng(2)
    x = tt(rng.standard_normal((B, 10, cfg.hidden_dim)).astype(np.float32))
    te = tt(rng.standard_normal((B, 7, cfg.text_dim)).astype(np.float32))
    t = torch.tensor([3, 8])
    out = tdit.ditto_forward(params, cfg, x, te, t,
                             generator=torch.Generator().manual_seed(seed))
    leaves = [p for _, p in tparams.tree_leaves(params)]
    return out.square().mean(), torch.autograd.grad(
        out.square().mean(), leaves, allow_unused=True,
        materialize_grads=True)


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("mode", ["output", "probs"])
def test_remat_reuses_the_dropout_mask(policy, mode):
    """Gradients with remat_blocks equal those without, dropout on, one
    generator seed: the recompute reuses each block's mask."""
    dit, _, _ = _fixtures()
    base = to_torch_cfg(DIT_CFG.replace(num_layers=1, cross_attn_dropout=0.3,
                                        attn_dropout_mode=mode))
    dit = dict(dit, blocks=dit["blocks"][:1])
    loss0, g0 = _dit_grads(base, dit, 11)
    loss1, g1 = _dit_grads(dataclasses.replace(
        base, remat_blocks=True, remat_policy=policy), dit, 11)
    loss2, _ = _dit_grads(base, dit, 12)
    assert torch.equal(loss0, loss1) and not torch.equal(loss0, loss2)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_unknown_remat_policy_raises():
    dit, _, _ = _fixtures()
    cfg = to_torch_cfg(DIT_CFG.replace(remat_blocks=True,
                                       remat_policy="everything"))
    with pytest.raises(ValueError, match="remat_policy"):
        _dit_grads(cfg, dit, 0)


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def test_train_state_keys_are_jax_keys(tmp_path):
    """A port train state and the JAX one flatten to the same .npz keys,
    shapes and dtypes; the seeded init has the JAX init_ditto tree."""
    dit, _, _ = _fixtures()
    jinit, _ = _jax_step(DIT_CFG, "float32")
    jstate = jinit(_jtree(dit))
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jstate)
    tstate = tparams.init_dit_train_state(to_torch_cfg(DIT_CFG), seed=4,
                                          device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), tstate)
    # the numpy form saves through JAX's own writer to the same file
    jckpt.save_checkpoint(str(tmp_path / "n.npz"),
                          tparams.train_state_to_numpy(tstate))
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t, \
            np.load(tmp_path / "n.npz") as n:
        assert sorted(j.files) == sorted(t.files) == sorted(n.files)
        for name in j.files:
            assert j[name].shape == t[name].shape, name
            assert j[name].dtype == t[name].dtype == n[name].dtype, name
            assert np.array_equal(t[name], n[name]), name
    assert {"k:opt_state//i:0//k:count", "k:opt_state//i:0//k:mu",
            "k:opt_state//i:0//k:nu", "k:step",
            "k:params//k:blocks//i:0//k:attn//k:in_proj_weight"} <= set(
                np.load(tmp_path / "j.npz").files)


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX-saved state restores into the port and steps as in JAX; a
    port-saved state restores into the JAX template; the .json metadata
    and latest_checkpoint behave as JAX's."""
    dit, frozen, batches = _fixtures()
    cfg = DIT_CFG.replace(cross_attn_dropout=0.0)
    jinit, jstep = _jax_step(cfg, "float32")
    batch = batches["latents"]
    key = jax.random.key(9)
    j1, _ = jstep(jinit(_jtree(dit)), _jtree(frozen), _jtree(batch), key)
    path = str(tmp_path / "ck" / "dit_epoch_1.npz")
    jckpt.save_checkpoint(path, j1, metadata={"epoch": 1})

    _, tstep, _ = _port_step(cfg, "float32")
    template = tparams.init_dit_train_state(to_torch_cfg(cfg), seed=0,
                                            device="cpu")
    t1 = tckpt.restore_into(template, path)
    assert t1["step"].dtype == torch.int32 and int(t1["step"]) == 1
    key2 = jax.random.key(10)
    j2, _ = jstep(j1, _jtree(frozen), _jtree(batch), key2)
    t, noise = _jax_draws(key2, cfg, T)
    t2, _ = tstep(t1, tparams.tree_map(tt, frozen),
                  {k: tt(v) for k, v in batch.items()}, t=t, noise=noise)
    _assert_states_close(t2, numpy_tree_of(j2), 1e-5)

    back = str(tmp_path / "ck" / "dit_epoch_2.npz")
    tckpt.save_checkpoint(back, t2, metadata={"epoch": 2})
    restored = jckpt.restore_into(j2, back)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(restored)[0],
            jax.tree_util.tree_flatten_with_path(j2)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert rel_err(a, b) <= 1e-5
    assert tckpt.latest_checkpoint(str(tmp_path / "ck"), "dit") == back
    assert jckpt.latest_checkpoint(str(tmp_path / "ck"), "dit") == back
    tree, meta = tckpt.load_checkpoint(back)
    assert meta == {"epoch": 2} and int(tree["step"]) == 2
    with pytest.raises(KeyError):
        tckpt.restore_into({"params": template["params"]}, back)


def test_trainer_fit_resume_and_best(tmp_path):
    """tests/test_train.py's fit / resume / JSONL checks on the port, and
    the best state by minimum validation loss."""
    dit, frozen, batches = _fixtures()
    cfg = to_torch_cfg(DIT_CFG)
    init_state, step_fn, eval_fn = tsteps.build_ditto_train_step(
        cfg, to_torch_cfg(CODEC_CFG), TGPT2, learning_rate=1e-3,
        device="cpu")
    tfrozen = tparams.tree_map(tt, frozen)
    batch = {k: tt(v) for k, v in batches["latents"].items()}
    ckdir = str(tmp_path / "ck")
    log = str(tmp_path / "log.jsonl")

    def run(epochs):
        return Trainer(step_fn, eval_fn).fit(
            init_state(tparams.tree_map(tt, dit)), tfrozen,
            train_batches=lambda: [batch, batch],
            val_batches=lambda: [batch], epochs=epochs,
            generator=torch.Generator().manual_seed(0), model_name="dit",
            checkpoint_dir=ckdir, checkpoint_interval=1, log_path=log,
            verbose=False)

    state, history = run(2)
    assert len(history["train"]["loss"]) == 2
    assert int(state["step"]) in (2, 4)
    for name in ("dit_epoch_1", "dit_epoch_2", "dit_best", "dit_final"):
        assert os.path.exists(os.path.join(ckdir, name + ".npz")), name
    vals = history["validation"]["loss"]
    best = tckpt.load_checkpoint(os.path.join(ckdir, "dit_best"))[0]
    assert int(best["step"]) == 2 * (1 + int(np.argmin(vals)))
    assert int(state["step"]) == int(best["step"])
    state2, history2 = run(3)         # resumes at epoch 2: one more epoch
    assert len(history2["train"]["loss"]) == 3
    lines = open(log).read().strip().split("\n")
    assert len(lines) == 3
    rec = json.loads(lines[0])
    assert rec["epoch"] == 1 and "loss" in rec["train"] and \
        "loss" in rec["val"]
    meta = json.load(open(os.path.join(ckdir, "dit_epoch_3.json")))
    assert meta["epoch"] == 3 and len(meta["history"]["train"]["loss"]) == 3


@pytest.mark.parametrize("wrapped", [False, True])
def test_convert_torch_checkpoint_matches_jax(tmp_path, wrapped):
    """A reference ``.pth``, a bare state dict or one under
    ``model_state_dict`` beside the trainer's other entries, reads as the
    JAX ``convert_torch_checkpoint`` reads it."""
    gen = torch.Generator().manual_seed(0)
    sd = {"proj.weight": torch.randn(4, 3, generator=gen),
          "proj.bias": torch.randn(4, generator=gen),
          "steps": torch.tensor([7], dtype=torch.int64)}
    obj = {"epoch": 3, "model_state_dict": sd, "loss": 0.5} if wrapped else sd
    path = str(tmp_path / "ref.pth")
    torch.save(obj, path)
    got, want = tckpt.convert_torch_checkpoint(path), \
        jckpt.convert_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name


def test_train_step_refuses_a_tree_on_another_device():
    """The step runs on its own device: a state or frozen tree elsewhere
    raises rather than training there."""
    _, frozen, batches = _fixtures()
    _, tstep, teval = _port_step(DIT_CFG, "float32")
    state = tparams.init_dit_train_state(to_torch_cfg(DIT_CFG), device="cpu")
    tfrozen = tparams.tree_map(tt, frozen)
    batch = {k: tt(v) for k, v in batches["latents"].items()}
    meta = functools.partial(tparams.tree_map, lambda t: t.to("meta"))
    for fn in (tstep, teval):
        with pytest.raises(ValueError, match="but state/.* lies on meta"):
            fn(meta(state), tfrozen, batch)
        with pytest.raises(ValueError, match="but frozen/codec/.* lies on meta"):
            fn(state, meta(tfrozen), batch)
