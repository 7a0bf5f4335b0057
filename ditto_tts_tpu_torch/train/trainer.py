"""Training harness: epochs, history, checkpoints, resume (the JAX
``train/trainer.py``).

``Trainer(step_fn, eval_fn).fit(...)`` runs the step builders of
``train/steps.py`` eagerly (no jit, no buffer donation: a step returns a
new state). Per epoch and per step it draws a seed from the caller's CPU
``torch.Generator`` (the JAX key split) and runs the step on a generator
of the state's device seeded with it. Metric sums stay on the device, with
one host transfer per epoch. Each epoch appends to the history and to an
optional JSONL log; every ``checkpoint_interval`` epochs it writes
``{model}_epoch_{n}.npz``; the best state by minimum validation loss goes
to ``{model}_best.npz`` (the reference's quirk #10, a best loss started at
0, corrected) and the returned state, the best one if there was a
validation loss, to ``{model}_final.npz``. ``resume`` restarts from
``latest_checkpoint``.

Under a (data, model) mesh the trainer takes ``shard_state`` (the
``StateSharding`` of ``parallel.train_setup.setup_mesh_training``), as
JAX's does: the state is this rank's share, every checkpoint is written
collectively (rank 0 writes the gathered state), a restored full state (a
resume, or the best one at the end) is sliced again, only rank 0 writes
the log and prints, and every rank takes rank 0's validation loss to pick
the best state. Every rank draws the same seeds, so the steps' global
draws agree.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ..params import tree_leaves
from .checkpoint import (latest_checkpoint, load_metadata, restore_into,
                         save_checkpoint)


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


class Trainer:
    def __init__(self, step_fn: Callable, eval_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.shard_state = None
        self.history: Dict = {
            "params": {"lr": None, "epochs": None, "model_name": None},
            "train": {"loss": [], "metrics": []},
            "validation": {"loss": [], "metrics": []},
        }

    def fit(self, state, frozen, train_batches: Callable[[], Iterable],
            val_batches: Optional[Callable[[], Iterable]] = None, *,
            epochs: int = 1, generator: torch.Generator,
            model_name: str = "model",
            learning_rate: Optional[float] = None,
            checkpoint_dir: str = "checkpoints",
            checkpoint_interval: int = 5, resume: bool = True,
            log_path: Optional[str] = None, verbose: bool = True,
            shard_state: Optional[Callable] = None):
        """Train ``epochs`` epochs (less those a resumed checkpoint has
        done); returns (final state, history). ``generator`` is a CPU
        ``torch.Generator``; the batches are on the state's device (this
        rank's rows under a mesh). ``shard_state``: see the module
        docstring."""
        self.shard_state = shard_state
        lead = shard_state is None or shard_state.mesh.rank == 0
        verbose = verbose and lead
        self.history["params"].update(
            {"lr": learning_rate, "epochs": epochs, "model_name": model_name})

        start_epoch = 0
        if resume:
            ckpt = latest_checkpoint(checkpoint_dir, prefix=model_name)
            if ckpt is not None:
                state = self._restore(state, ckpt)
                meta = load_metadata(ckpt)
                if meta:
                    start_epoch = int(meta.get("epoch", 0))
                    self.history = meta.get("history", self.history)
                if verbose:
                    print(f"[trainer] resumed from {ckpt} "
                          f"at epoch {start_epoch}")

        best_loss = float("inf")
        best_path = None
        log_f = open(log_path, "a") if log_path and lead else None
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                state, train_metrics = self._run_epoch(
                    state, frozen, train_batches(), _seed(generator),
                    train=True)
                val_metrics = {}
                if val_batches is not None and self.eval_fn is not None:
                    _, val_metrics = self._run_epoch(
                        state, frozen, val_batches(), _seed(generator),
                        train=False)

                self.history["train"]["loss"].append(
                    train_metrics.get("loss"))
                self.history["train"]["metrics"].append(train_metrics)
                self.history["validation"]["loss"].append(
                    val_metrics.get("loss"))
                self.history["validation"]["metrics"].append(val_metrics)

                if log_f:
                    log_f.write(json.dumps(
                        {"epoch": epoch + 1, "train": train_metrics,
                         "val": val_metrics,
                         "seconds": round(time.time() - t0, 2)}) + "\n")
                    log_f.flush()
                if verbose:
                    print(f"[trainer] epoch {epoch + 1}: "
                          f"train {train_metrics} val {val_metrics} "
                          f"({time.time() - t0:.1f}s)")

                vloss = val_metrics.get("loss")
                if vloss is not None and shard_state is not None:
                    vloss = shard_state.mesh.agree(vloss,
                                                   shard_state.device)
                if vloss is not None and vloss < best_loss:
                    # the best state lives on disk, not as a second copy
                    # of the train state in device memory
                    best_loss = vloss
                    best_path = self._save(checkpoint_dir, model_name,
                                           "best", state)

                if (epoch + 1) % checkpoint_interval == 0:
                    self._save(checkpoint_dir, model_name, epoch + 1, state)
        finally:
            if log_f:
                log_f.close()

        final = state if best_path is None else \
            self._restore(state, best_path)
        self._save(checkpoint_dir, model_name, "final", final)
        return final, self.history

    def _restore(self, state, path):
        if self.shard_state is None:
            return restore_into(state, path)
        return self.shard_state(restore_into(
            self.shard_state.full_like(state), path))

    # ------------------------------------------------------------------

    def _run_epoch(self, state, frozen, batches, seed: int, *, train: bool):
        # metric sums stay on the device: one host transfer per epoch
        device = next(tree_leaves(state["params"]))[1].device
        epoch_gen = torch.Generator().manual_seed(seed)
        sums: Optional[Dict] = None
        count = 0
        for batch in batches:
            gen = torch.Generator(device=device).manual_seed(
                _seed(epoch_gen))
            if train:
                state, metrics = self.step_fn(state, frozen, batch, gen)
            else:
                metrics = self.eval_fn(state, frozen, batch, gen)
            count += 1
            sums = dict(metrics) if sums is None else {
                k: sums[k] + v for k, v in metrics.items()}
        if sums is None:
            return state, {}
        values = torch.stack([sums[k].float() for k in sums]).cpu().tolist()
        return state, {k: v / count for k, v in zip(sums, values)}

    def _save(self, checkpoint_dir, model_name, epoch, state):
        tag = epoch if isinstance(epoch, str) else f"epoch_{epoch}"
        path = os.path.join(checkpoint_dir, f"{model_name}_{tag}.npz")
        meta = {"epoch": epoch if isinstance(epoch, int) else None,
                "history": self.history}
        sh = self.shard_state
        save_checkpoint(path, state, metadata=meta,
                        mesh=None if sh is None else sh.mesh,
                        specs=None if sh is None else sh.specs)
        return path

