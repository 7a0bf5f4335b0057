"""Mesh wiring for the training entry points (the JAX package's
``parallel/train_setup.py``): how a train state shards over the (data,
model) mesh. Used by the three training CLIs and by ``dryrun_multichip``,
so the dry run takes the CLIs' code.

  * The trainable parameters shard by their rules (``sharding.py``); the
    AdamW ``mu`` / ``nu`` mirror them leaf by leaf; ``count`` and ``step``
    are replicated. Flat AdamW (one raveled vector) has replicated moments,
    which fits data parallelism only: with a sharded parameter it raises,
    and the step is built with ``flat_opt=False`` (as the CLIs do under
    ``--mesh-model`` > 1).
  * The frozen trees (codec, GPT2, embedding head, ByT5) are replicated:
    every rank keeps them whole.
  * A batch splits its leading axis over "data": each rank keeps its rows
    of the global batch that every rank builds alike.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..params import tree_leaves
from . import sharding as shard_mod
from .mesh import Mesh


def state_specs(state: Dict, param_specs: Any) -> Dict:
    """The spec tree of a train state ({params, opt_state, step}): the
    given specs on params, mirrored on AdamW mu / nu when they are trees;
    flat moments are replicated."""
    mu = () if isinstance(state["opt_state"][0]["mu"], torch.Tensor) \
        else param_specs
    return {"params": param_specs,
            "opt_state": [{"count": (), "mu": mu, "nu": mu}],
            "step": ()}


def ditto_state_specs(state: Dict) -> Dict:
    """JAX's DiT rules on the params (``sharding.dit_param_specs``),
    mirrored on AdamW."""
    return state_specs(state, shard_mod.dit_param_specs(state["params"]))


def batch_specs(batch: Any) -> Any:
    """Every batch leaf's leading axis over "data"."""
    return {k: ("data",) for k in batch}


class StateSharding:
    """The ``shard_state`` of ``setup_mesh_training``. Called on a full
    train state (tensors on any device, or numpy arrays), it returns this
    rank's slices on ``device``; ``gather`` returns the full state on every
    rank (collective); ``full_like`` a tree of the full shapes on the
    ``meta`` device, a template for ``checkpoint.restore_into``."""

    def __init__(self, mesh: Mesh, specs: Dict, device):
        self.mesh, self.specs, self.device = mesh, specs, device

    def __call__(self, state: Dict) -> Dict:
        local = shard_mod.shard_tree(self.mesh, shard_mod.map_tree(
            lambda a, *_: torch.as_tensor(a), state), self.specs)
        # a copy: a slice would keep the full tensor alive
        return shard_mod.map_tree(
            lambda t, *_: t.to(self.device, copy=True), local)

    def gather(self, state: Dict) -> Dict:
        return shard_mod.gather_tree(self.mesh, state, self.specs)

    def full_like(self, state: Dict) -> Dict:
        def full(leaf, spec, path):
            shape = list(leaf.shape)
            for dim, axis in enumerate(spec):
                if axis:
                    shape[dim] *= self.mesh.size(axis)
            return torch.empty(shape, dtype=leaf.dtype, device="meta")
        return shard_mod.map_tree(full, state, self.specs)


def setup_mesh_training(mesh: Mesh, state: Dict, frozen: Dict,
                        param_specs: Any = None
                        ) -> Tuple[Dict, Dict, StateSharding, Callable]:
    """(state, frozen, shard_state, shard_batch): this rank's slice of the
    full ``state`` (on the state's device), the frozen trees as they are
    (replicated), the ``StateSharding`` that re-slices a restored full
    state, and ``shard_batch(batch)``, this rank's rows of a global batch.

    ``param_specs`` defaults to the DiT rules as JAX states them; pass
    ``sharding.dit_param_specs(params, cfg, model)`` where the attention
    may not split, ``sharding.slp_param_specs(...)`` for the SLP decoder,
    ``sharding.replicated_specs(...)`` for pure data parallelism (NAC)."""
    specs = (ditto_state_specs(state) if param_specs is None
             else state_specs(state, param_specs))
    if mesh.model > 1 and specs["opt_state"][0]["mu"] == () and \
            shard_mod.is_sharded(specs["params"]):
        raise ValueError(
            "tensor parallelism shards the AdamW moments with their "
            "parameters; flat AdamW keeps one replicated vector: build the "
            "step with flat_opt=False")
    device = next(tree_leaves(state["params"]))[1].device
    shard_state = StateSharding(mesh, specs, device)

    def shard_batch(batch: Dict) -> Dict:
        return shard_mod.shard_tree(mesh, {k: torch.as_tensor(v)
                                           for k, v in batch.items()},
                                    batch_specs(batch))

    return shard_state(state), frozen, shard_state, shard_batch
