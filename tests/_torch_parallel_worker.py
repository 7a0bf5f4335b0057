"""One rank of the port's mesh training tests (tests/test_torch_parallel.py):

    python _torch_parallel_worker.py RANK WORLD PORT OUTDIR CASES_JSON

Joins a gloo world of WORLD processes on localhost:PORT and runs each case
of CASES_JSON (a list of dicts, see ``case_inputs``) on the CPU: a (data,
model) mesh, ``setup_mesh_training`` on the full state, one train step of
this rank's rows, and the gathered state, which rank 0 writes to
OUTDIR/<name>.npz (loss; params, mu and nu raveled) for the test to hold
against the one-process step. A ``checkpoint`` case also saves
collectively, restores through ``StateSharding`` and steps both states,
which must agree bit for bit. A ``fit`` case runs ``Trainer.fit`` (see
``fit``) in place of the one step. Every case checks that gathering the
sharded state gives the full one back, bit for bit. Imports torch and the
port only.

``case_inputs`` builds every input from numpy seeds, so the test process
builds the same ones for the one-process step and for JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ditto_tts_tpu_torch import params as tparams  # noqa: E402
from ditto_tts_tpu_torch.config import (ByT5Config, CodecConfig, DiTConfig,
                                        GPT2Config, MeshConfig, NACConfig,
                                        SLPConfig)
from ditto_tts_tpu_torch.models import nac as tnac
from ditto_tts_tpu_torch.parallel import sharding
from ditto_tts_tpu_torch.parallel.mesh import (initialize_distributed,
                                               make_mesh)
from ditto_tts_tpu_torch.parallel.train_setup import setup_mesh_training
from ditto_tts_tpu_torch.train import steps as tsteps
from ditto_tts_tpu_torch.train.checkpoint import (restore_into,
                                                  save_checkpoint)
from ditto_tts_tpu_torch.train.trainer import Trainer

B, T, L, LR = 4, 6, 64, 1e-4
DIT = DiTConfig(hidden_dim=16, num_layers=2, num_heads=4, time_dim=8,
                text_dim=16, diffusion_steps=10, max_token_length=64,
                cross_attn_dropout=0.0)
GPT2 = GPT2Config(vocab_size=32, n_positions=64, n_embd=16, n_layer=1,
                  n_head=2)
CODEC = CodecConfig(num_filters=4, dimension=8, ratios=(2, 2, 2),
                    codebook_size=16, num_quantizers=4, lstm_layers=1)
SLP = SLPConfig(embedding_dim=16, num_layers=1, num_heads=1)
BYT5 = ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32, num_layers=1,
                  num_heads=2)


def _jitter(tree, seed):
    """Every leaf plus 0.1 N(0, 1), so ones and zeros are not trivial."""
    rng = np.random.default_rng(seed)
    return tparams.tree_map(lambda t: t + torch.from_numpy(
        0.1 * rng.standard_normal(tuple(t.shape)).astype(np.float32)), tree)


def case_inputs(case):
    """(cfg, full state, frozen, global batch, step kwargs) of a case:
    ``kind`` "dit" (``cfg`` overrides of DIT, ``path`` "latents" or
    "audio") or "slp"; ``flat`` AdamW; ``gen`` a generator seed (draws t,
    noise and dropout) or ``draws`` an .npz of t and noise, else numpy
    draws. The step kwargs go to ``run_step``."""
    rng = np.random.default_rng(0)
    flat = case.get("flat", False)
    if case["kind"] == "slp":
        cfg = SLP
        state = tparams.init_slp_train_state(cfg, CODEC.codebook_size, 1,
                                             device="cpu", flat_opt=flat)
        frozen = tparams.init_slp_frozen(CODEC, BYT5, seed=2, device="cpu")
        mask = np.ones((B, 9), np.int32)
        mask[2, 6:] = 0
        batch = {"audio": 0.1 * rng.standard_normal((B, 1, L)),
                 "padding_mask": np.ones((B, L), np.int32),
                 "text_ids": rng.integers(3, BYT5.vocab_size, (B, 9)),
                 "text_mask": mask, "label": np.asarray([0, 3, 10, 3])}
        kw = {}
    else:
        cfg = DIT.replace(**case.get("cfg", {}))
        state = tparams.init_dit_train_state(cfg, 0, flat_opt=flat,
                                             device="cpu")
        frozen = tparams.init_nac_frozen(CODEC, GPT2, seed=2, device="cpu")
        frozen = {"codec": frozen["codec"], "gpt2": {"wte": frozen["gpt2"][
            "wte"]}, "embedding_head": tnac.init_nac_trainable(
                NACConfig(hidden_size=16, codebook_size=16),
                seed=3)["embedding_head"]}
        if case.get("path") == "audio":
            frames = L // CODEC.hop_length
            batch = {"audio": 0.1 * rng.standard_normal((B, 1, L)),
                     "padding_mask": np.ones((B, L), np.int32)}
        else:
            frames = T
            batch = {"latents": rng.standard_normal((B, T, cfg.hidden_dim))}
        batch["text_ids"] = rng.integers(0, GPT2.vocab_size, (B, frames))
        if "gen" in case:
            kw = {"gen": case["gen"]}
        elif "draws" in case:
            with np.load(case["draws"]) as z:
                kw = {"t": torch.from_numpy(z["t"]),
                      "noise": torch.from_numpy(z["noise"])}
        else:
            kw = {"t": torch.from_numpy(rng.integers(0, cfg.diffusion_steps,
                                                     (B,))),
                  "noise": torch.from_numpy(rng.standard_normal(
                      (B, frames, cfg.hidden_dim)).astype(np.float32))}
    state = tparams.new_train_state(_jitter(state["params"], 4), flat)
    batch = {k: torch.from_numpy(np.asarray(v, np.float32 if np.asarray(
        v).dtype == np.float64 else np.int32)) for k, v in batch.items()}
    return cfg, state, frozen, batch, kw


def build_step(case, cfg, mesh=None):
    """(init_state, step_fn, eval_fn) of the case, on the CPU."""
    flat = case.get("flat", False)
    if case["kind"] == "slp":
        return tsteps.build_slp_train_step(cfg, CODEC, BYT5,
                                           learning_rate=LR, flat_opt=flat,
                                           device="cpu", mesh=mesh)
    return tsteps.build_ditto_train_step(cfg, CODEC, GPT2, learning_rate=LR,
                                         flat_opt=flat, device="cpu",
                                         mesh=mesh)


def param_specs(case, cfg, params, model):
    if case["kind"] == "slp":
        return sharding.slp_param_specs(params, cfg, model)
    return sharding.dit_param_specs(params, cfg, model)


def ravel_state(state):
    """(params, mu, nu) of a full state, each one flat numpy vector."""
    adam = state["opt_state"][0]
    return [tparams.ravel_tree(t)[0].numpy() if not isinstance(
        t, torch.Tensor) else t.numpy()
        for t in (state["params"], adam["mu"], adam["nu"])]


def run_step(step_fn, state, frozen, batch, kw):
    """``step_fn`` with the case's draws: a fresh generator of seed
    ``kw["gen"]``, or the ``t`` / ``noise`` overrides."""
    kw = dict(kw)
    gen = kw.pop("gen", None)
    return step_fn(state, frozen, batch, None if gen is None
                   else torch.Generator().manual_seed(gen), **kw)


def fit(step_fn, eval_fn, state, frozen, batch, ckdir, shard_state=None):
    """``Trainer.fit`` for 2 epochs of one step, a validation pass each,
    then resumed to 3: (final state, history)."""
    os.makedirs(ckdir, exist_ok=True)
    for epochs in (2, 3):
        trainer = Trainer(step_fn, eval_fn)
        final, hist = trainer.fit(
            state, frozen, lambda: [batch], lambda: [batch], epochs=epochs,
            generator=torch.Generator().manual_seed(0), model_name="dit",
            checkpoint_dir=ckdir, checkpoint_interval=1, verbose=False,
            log_path=os.path.join(ckdir, "log.jsonl"),
            shard_state=shard_state)
    return final, hist


def run_case(case, rank, outdir):
    mesh = make_mesh(MeshConfig(data=case["data"], model=case["model"]))
    cfg, full, frozen, batch, kw = case_inputs(case)
    _, step_fn, _ = build_step(case, cfg, mesh)
    state, frozen, shard_state, shard_batch = setup_mesh_training(
        mesh, full, frozen,
        param_specs(case, cfg, full["params"], mesh.model))
    # gather(shard(x)) == x, the packed in_proj included
    for (path, a), (_, b) in zip(tparams.tree_leaves(full),
                                 tparams.tree_leaves(
                                     shard_state.gather(state))):
        assert torch.equal(a, b), f"gather(shard(x)) differs at {path}"
    local = shard_batch(batch)
    if case.get("fit"):
        _, _, eval_fn = build_step(case, cfg, mesh)
        new, hist = fit(step_fn, eval_fn, state, frozen, local,
                        os.path.join(outdir, case["name"]), shard_state)
        metrics = {"loss": torch.tensor(hist["train"]["loss"][-1])}
    else:
        new, metrics = run_step(step_fn, state, frozen, local, kw)
    full = shard_state.gather(new)
    if rank == 0:
        p, mu, nu = ravel_state(full)
        np.savez(os.path.join(outdir, case["name"] + ".npz"),
                 loss=metrics["loss"].numpy(), params=p, mu=mu, nu=nu,
                 step=full["step"].numpy())
    if case.get("checkpoint"):
        path = os.path.join(outdir, case["name"] + "_ckpt.npz")
        save_checkpoint(path, new, {"epoch": 1}, mesh=mesh,
                        specs=shard_state.specs)
        back = shard_state(restore_into(shard_state.full_like(new), path))
        for (pa, a), (_, b) in zip(tparams.tree_leaves(new),
                                   tparams.tree_leaves(back)):
            assert torch.equal(a, b), f"restored {pa} differs"
        nxt = [run_step(step_fn, s, frozen, local, kw)[0]
               for s in (new, back)]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tparams.tree_leaves(nxt[0]), tparams.tree_leaves(nxt[1]))), \
            "a step from the restored state differs"
    print(f"[rank {rank}] {case['name']} mesh {mesh.shape} loss "
          f"{float(metrics['loss']):.6f}", flush=True)


def main():
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    cases = json.loads(sys.argv[5])
    initialize_distributed("gloo", f"tcp://localhost:{port}", world, rank,
                           timeout=120)
    for case in cases:
        run_case(case, rank, outdir)
    torch.distributed.destroy_process_group()
    print(f"[rank {rank}] PARALLEL_OK", flush=True)


if __name__ == "__main__":
    main()
