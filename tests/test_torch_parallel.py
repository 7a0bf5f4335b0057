"""The port's data and tensor parallelism (``ditto_tts_tpu_torch/parallel``)
on the CPU: JAX's rule tables, the head-aligned split of the packed
in_proj, and train steps over gloo worlds of 2 and 4 processes
(tests/_torch_parallel_worker.py) held against the one-process port step
and, at (2 x 2), against JAX's own mesh step (``setup_mesh_training`` on
the 8-device virtual CPU mesh of tests/conftest.py, dropout 0, the t and
noise JAX draws); a collective checkpoint that JAX's ``restore_into``
reads; and ``initialize_distributed``'s failure propagation.

Tolerances (max |mesh - reference| over max |reference|, fp32): loss 1e-5;
mu and nu 1e-5 (after one step mu = 0.1 g: the gradient); params 1e-5,
except where the reference gradient is rounding noise (|mu| <= 1e-6 x
max|mu|: the attention's key bias, whose exact gradient is zero): Adam's
first step divides such a g by |g| + eps, so each side moves those
elements by up to lr in a direction of its own, and they are held to
2 lr. Tensor parallelism sums each row-parallel product in two shares,
and data parallelism averages two half-batch means: both reorder fp32
sums.

The workers inherit tests/_torch_port_util.py's one-thread policy.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.core.config import CodecConfig as JCodec
from ditto_tts_tpu.core.config import DiTConfig as JDiT
from ditto_tts_tpu.core.config import MeshConfig as JMesh
from ditto_tts_tpu.core.config import SLPConfig as JSLP
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.models import slp as jslp
from ditto_tts_tpu.parallel import mesh as jmesh
from ditto_tts_tpu.parallel import sharding as jsharding
from ditto_tts_tpu.parallel.train_setup import setup_mesh_training as jsetup
from ditto_tts_tpu.text import gpt2 as jgpt2
from ditto_tts_tpu.train import checkpoint as jckpt
from ditto_tts_tpu.train import steps as jsteps

from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import MeshConfig
from ditto_tts_tpu_torch.parallel import sharding
from ditto_tts_tpu_torch.parallel.mesh import (Mesh, auto_mesh,
                                               batch_sharding,
                                               initialize_distributed,
                                               make_mesh, replicated)
from ditto_tts_tpu_torch.parallel.train_setup import setup_mesh_training
from ditto_tts_tpu_torch.train import checkpoint as tckpt

import _torch_parallel_worker as W
import _torch_port_util  # noqa: F401  (the one-thread policy)

_HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5

# 2 ranks: (data, model) = (1, 2) and (2, 1)
TWO_RANK = [
    {"name": "dit_tp", "kind": "dit", "data": 1, "model": 2},
    {"name": "dit_dp_audio_flat", "kind": "dit", "data": 2, "model": 1,
     "path": "audio", "flat": True},
    {"name": "dit_tp_remat_dropout", "kind": "dit", "data": 1, "model": 2,
     "gen": 7, "cfg": {"remat_blocks": True, "cross_attn_dropout": 0.1}},
    {"name": "dit_tp_probs_dropout", "kind": "dit", "data": 1, "model": 2,
     "gen": 7, "cfg": {"cross_attn_dropout": 0.1,
                       "attn_dropout_mode": "probs"}},
    {"name": "dit_dp_dropout", "kind": "dit", "data": 2, "model": 1,
     "gen": 7, "cfg": {"cross_attn_dropout": 0.1}},
    {"name": "dit_tp_ref_compat", "kind": "dit", "data": 1, "model": 2,
     "cfg": {"ref_compat": True}},
    {"name": "dit_tp_one_head", "kind": "dit", "data": 1, "model": 2,
     "cfg": {"num_heads": 1}},
    {"name": "slp_tp_one_head", "kind": "slp", "data": 1, "model": 2},
    {"name": "dit_tp_checkpoint", "kind": "dit", "data": 1, "model": 2,
     "checkpoint": True},
]
FOUR_RANK = [
    {"name": "dit_2x2", "kind": "dit", "data": 2, "model": 2},
    {"name": "dit_2x2_jax_draws", "kind": "dit", "data": 2, "model": 2},
    {"name": "dit_2x2_fit", "kind": "dit", "data": 2, "model": 2,
     "fit": True, "cfg": {"cross_attn_dropout": 0.1}},
]
JAX_KEY = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world, cases, outdir):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_torch_parallel_worker.py"),
         str(r), str(world), port, str(outdir), json.dumps(cases)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "PARALLEL_OK" in out, \
            f"rank {r}:\n{out[-4000:]}"
    return outs


def _jax_draws(cfg):
    """t and the noise as JAX's loss draws them (split(key, 3))."""
    k_t, k_n, _ = jax.random.split(jax.random.key(JAX_KEY), 3)
    t = jax.random.randint(k_t, (W.B,), 0, cfg.diffusion_steps)
    noise = jax.random.normal(k_n, (W.B, W.T, cfg.hidden_dim), jnp.float32)
    return np.asarray(t), np.asarray(noise)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    t, noise = _jax_draws(W.DIT)
    np.savez(out / "jax_draws.npz", t=t.astype(np.int32), noise=noise)
    FOUR_RANK[1]["draws"] = str(out / "jax_draws.npz")
    _launch(2, TWO_RANK, out)
    _launch(4, FOUR_RANK, out)
    return out


def _one_process(case, tmp):
    cfg, state, frozen, batch, kw = W.case_inputs(case)
    _, step_fn, eval_fn = W.build_step(case, cfg)
    if case.get("fit"):
        new, hist = W.fit(step_fn, eval_fn, state, frozen, batch, str(tmp))
        loss = hist["train"]["loss"][-1]
    else:
        new, metrics = W.run_step(step_fn, state, frozen, batch, kw)
        loss = float(metrics["loss"])
    return loss, W.ravel_state(new), W.ravel_state(state)[0]


def _assert_step_close(got, loss, ref, before, steps=1):
    """got: a worker's .npz; ref: (params, mu, nu) raveled."""
    p, mu, nu = ref
    assert abs(float(got["loss"]) - loss) <= TOL * abs(loss)
    assert int(got["step"]) == steps
    for key, want in (("mu", mu), ("nu", nu)):
        err = np.abs(got[key] - want).max()
        assert err <= TOL * np.abs(want).max(), (key, err)
    noise = np.abs(mu) <= 1e-6 * np.abs(mu).max()
    err = np.abs(got["params"] - p)
    assert err[~noise].max() <= TOL * np.abs(p).max(), err[~noise].max()
    if noise.any():
        assert err[noise].max() <= 2 * W.LR + 1e-6 * np.abs(p).max()
    # every parameter moved (the step is not a no-op)
    assert np.abs(p - before).max() > 0.5 * W.LR


@pytest.mark.parametrize("case", TWO_RANK + FOUR_RANK,
                         ids=lambda c: c["name"])
def test_mesh_step_matches_one_process(results, case, tmp_path):
    """One step; for ``dit_2x2_fit``, ``Trainer.fit``'s 2 epochs, each
    validated, resumed to 3: the best epoch's state, restored and sliced
    again on every rank, against one process's fit."""
    with np.load(results / f"{case['name']}.npz") as got:
        loss, ref, before = _one_process(case, tmp_path)
        _assert_step_close(got, loss, ref, before,
                           steps=3 if case.get("fit") else 1)
    if case.get("fit"):
        files = sorted(os.listdir(results / case["name"]))
        assert files == sorted(os.listdir(tmp_path))
        assert "dit_best.npz" in files and "dit_epoch_3.npz" in files
        # rank 0 alone wrote the log: one line an epoch
        with open(results / case["name"] / "log.jsonl") as f:
            assert [json.loads(x)["epoch"] for x in f] == [1, 2, 3]


def _jax_state_numpy(state):
    """A JAX train state as the port's raveled (params, mu, nu)."""
    tstate = tparams.from_jax_train_state(
        jax.tree_util.tree_map(np.asarray, state))
    return W.ravel_state(tstate)


def test_2x2_matches_the_jax_mesh_step(results, devices8):
    """(data 2, model 2) in four gloo processes against JAX's
    ``setup_mesh_training`` and jitted step on four virtual CPU devices,
    from the same state, batch, t and noise."""
    case = FOUR_RANK[1]
    _, state, frozen, batch, _ = W.case_inputs(case)
    jcfg = JDiT.from_json(W.DIT.to_json())
    jinit, jstep, _ = jsteps.build_ditto_train_step(
        jcfg, JCodec.from_json(W.CODEC.to_json()),
        jgpt2.GPT2Config(**{k: getattr(W.GPT2, k) for k in (
            "vocab_size", "n_positions", "n_embd", "n_layer", "n_head")}),
        learning_rate=W.LR, flat_opt=False)
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                   {"params": state["params"],
                                    "frozen": {"gpt2": frozen["gpt2"]}})
    mesh = jmesh.make_mesh(JMesh(data=2, model=2), devices8[:4])
    jstate, jfrozen, _, shard_batch = jsetup(
        mesh, jinit(jtree["params"]), jtree["frozen"])
    jbatch = shard_batch({k: jnp.asarray(v.numpy())
                          for k, v in batch.items()})
    with jax.set_mesh(mesh):
        new, metrics = jax.jit(jstep)(jstate, jfrozen, jbatch,
                                      jax.random.key(JAX_KEY))
    p, mu, nu = _jax_state_numpy(new)
    with np.load(results / f"{case['name']}.npz") as got:
        _assert_step_close(got, float(metrics["loss"]), (p, mu, nu),
                           W.ravel_state(state)[0])


def test_tp_checkpoint_has_jax_keys_and_restores(results):
    """The file a (1 x 2) run wrote collectively: JAX's keys and full
    shapes (those of JAX's own state flattened), and it restores into a
    one-process port state and through JAX's ``restore_into`` into a JAX
    state, equal to the gathered state the worker wrote."""
    path = str(results / "dit_tp_checkpoint_ckpt.npz")
    case = TWO_RANK[-1]
    cfg, state, _, _, _ = W.case_inputs(case)
    jcfg = JDiT.from_json(cfg.to_json())
    jinit, _, _ = jsteps.build_ditto_train_step(
        jcfg, JCodec.from_json(W.CODEC.to_json()),
        jgpt2.GPT2Config(vocab_size=32, n_positions=64, n_embd=16,
                         n_layer=1, n_head=2), flat_opt=False)
    jtemplate = jinit(jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.shape, jnp.float32), state["params"]))
    want_keys = {k: v.shape for k, v in jckpt._flatten(jtemplate).items()}
    with np.load(path) as z:
        assert {k: z[k].shape for k in z.files} == want_keys
    restored = tckpt.restore_into(state, path)
    jrestored = jckpt.restore_into(jtemplate, path)
    with np.load(results / "dit_tp_checkpoint.npz") as got:
        for ravelled in (W.ravel_state(restored),
                         _jax_state_numpy(jrestored)):
            for key, arr in zip(("params", "mu", "nu"), ravelled):
                np.testing.assert_array_equal(arr, got[key])
    assert int(restored["step"]) == 1 and int(jrestored["step"]) == 1


# ---------------------------------------------------------------------------
# rules, layout and the mesh's refusals (in this process)
# ---------------------------------------------------------------------------

def _jax_trees():
    key = jax.random.key(0)
    return {
        "dit": (jax.eval_shape(lambda: jdit.init_ditto(key, JDiT(
            hidden_dim=16, num_layers=2, num_heads=4, time_dim=8,
            text_dim=16))), jsharding._DIT_RULES, sharding._DIT_RULES),
        "slp": (jax.eval_shape(lambda: jslp.init_slp_trainable(
            key, JSLP(embedding_dim=16, num_layers=2, num_heads=1), 16)),
            jsharding._SLP_RULES, sharding._SLP_RULES),
        "gpt2": (jax.eval_shape(lambda: jgpt2.init_gpt2(
            key, jgpt2.GPT2Config(vocab_size=32, n_positions=16, n_embd=16,
                                  n_layer=2, n_head=2))),
                 jsharding._GPT2_RULES, sharding._GPT2_RULES),
    }


@pytest.mark.parametrize("model", ["dit", "slp", "gpt2"])
def test_rule_tables_are_jax_s(model):
    """The tables letter for letter, and every JAX path's spec."""
    tree, jrules, trules = _jax_trees()[model]
    assert [(pat, tuple(spec)) for pat, spec in jrules] == trules
    specs = jsharding.tree_specs(tree, jrules)
    paths = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert paths
    sharded = 0
    for path, spec in paths:
        p = jsharding._path_str(path)
        assert sharding.spec_for_path(p, trules) == tuple(spec), p
        sharded += any(spec)
    assert sharded > 0


def test_packed_in_proj_splits_by_heads():
    """Rank r of 2 holds heads [2r, 2r + 2) of q, of k and of v (JAX's
    ``P("model", None)`` on the stacked rows would give rank 0 q and half
    of k); the out_proj its input columns; biases of row-parallel layers
    stay whole."""
    cfg = W.DIT
    params = W.case_inputs({"kind": "dit"})[1]["params"]
    specs = sharding.dit_param_specs(params, cfg, 2)
    blk = params["blocks"][0]
    h, share = cfg.hidden_dim, cfg.hidden_dim // 2
    for r in range(2):
        local = sharding.shard_tree(Mesh(1, 2, r), params, specs)
        lb = local["blocks"][0]
        for name in ("attn", "cross_attn"):
            w, b = blk[name]["in_proj_weight"], blk[name]["in_proj_bias"]
            lw, lbias = lb[name]["in_proj_weight"], lb[name]["in_proj_bias"]
            assert lw.shape == (3 * share, h)
            for j in range(3):
                rows = slice(j * h + r * share, j * h + (r + 1) * share)
                assert torch.equal(lw[j * share:(j + 1) * share], w[rows])
                assert torch.equal(lbias[j * share:(j + 1) * share],
                                   b[rows])
            assert torch.equal(lb[name]["out_proj"]["weight"],
                               blk[name]["out_proj"]["weight"][
                                   :, r * share:(r + 1) * share])
            assert torch.equal(lb[name]["out_proj"]["bias"],
                               blk[name]["out_proj"]["bias"])
        assert torch.equal(lb["mlp_fc2"]["bias"], blk["mlp_fc2"]["bias"])


@pytest.mark.parametrize("cfg_kw,model,whole", [
    ({}, 2, []),
    ({"num_heads": 1}, 2, ["attn", "cross_attn"]),
    ({"num_heads": 4}, 3, ["attn", "cross_attn"]),
    ({"ref_compat": True}, 2, ["attn"]),
])
def test_attention_that_cannot_split_stays_whole(cfg_kw, model, whole):
    """``dit_param_specs`` with the config keeps the projections of an
    attention whole where the heads do not divide over the model axis, and
    the self-attention under ref_compat; the MLP shards in every case."""
    cfg = W.DIT.replace(**cfg_kw)
    params = tparams.init_dit_train_state(cfg, 0, device="cpu")["params"]
    blk = sharding.dit_param_specs(params, cfg, model)["blocks"][0]
    for name in ("attn", "cross_attn"):
        want = () if name in whole else ("model", None)
        assert blk[name]["in_proj_weight"] == want
        assert blk[name]["out_proj"]["weight"] == (
            () if name in whole else (None, "model"))
    assert blk["mlp_fc1"]["weight"] == ("model", None)
    assert blk["mlp_fc2"]["weight"] == (None, "model")


def test_flat_adamw_under_tensor_parallelism_raises():
    cfg, state, frozen, _, _ = W.case_inputs({"kind": "dit", "flat": True})
    specs = sharding.dit_param_specs(state["params"], cfg, 2)
    with pytest.raises(ValueError, match="flat_opt=False"):
        setup_mesh_training(Mesh(1, 2, 0), state, frozen, specs)
    # pure data parallelism keeps the flat moments (replicated)
    setup_mesh_training(Mesh(2, 1, 0), state, frozen, specs)


def test_mesh_larger_than_the_world_raises():
    assert not torch.distributed.is_initialized()
    assert make_mesh(MeshConfig()).shape == {"data": 1, "model": 1}
    assert auto_mesh(1).shape == {"data": 1, "model": 1}
    for data, model in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="needs"):
            make_mesh(MeshConfig(data=data, model=model))


def test_initialize_distributed_without_a_launcher_stays_alone(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed("gloo")
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_explicit_failure_propagates():
    """Explicit arguments must fail fast, not fall back to one process
    (the twin of tests/test_multihost.py's)."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(Exception):
        # rank 7 of 2 at a port nobody serves
        initialize_distributed("gloo", f"tcp://localhost:{_free_port()}",
                               world_size=2, rank=7, timeout=2)
    assert not torch.distributed.is_initialized()


def test_batch_rows_and_replicated():
    """Data rank d of D keeps rows [d B / D, (d + 1) B / D) of the global
    batch, whatever its model index; a replicated tensor stays whole; a
    batch that does not split raises."""
    x = torch.arange(24).reshape(8, 3)
    for rank in range(4):
        mesh = Mesh(2, 2, rank)
        rows = batch_sharding(mesh)(x)
        d = rank // 2
        assert torch.equal(rows, x[4 * d:4 * d + 4])
        assert replicated(mesh)(x) is x
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(Mesh(3, 1, 0))(x)
