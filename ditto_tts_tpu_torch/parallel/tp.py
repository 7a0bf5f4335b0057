"""Megatron tensor parallelism over the mesh's model group: the pair of
``autograd.Function``s that bracket a column-parallel -> row-parallel pair
of layers (an attention's packed in_proj -> out_proj, an MLP's fc1 / gate
-> fc2), so a block takes one all-reduce per attention and one per MLP in
the forward, as GSPMD inserts them for the JAX rules
(``parallel/sharding.py``).

  * ``copy_to_model`` (f): the identity forward; the backward sums the
    input's gradient over the model group. A replicated input feeds every
    rank's share of the heads or of the MLP's hidden units, so its gradient
    is the sum of the shares'. Without it the gradients of every
    replicated parameter upstream (norms, ``global_adaln``, ``proj_in``,
    ``t_embedding``) would be partial and differ across the group.
  * ``reduce_from_model`` (g): the forward sums the row-parallel partial
    products over the model group; the backward is the identity.

``row_parallel`` is a row-parallel ``dense``: the local product, g, then
the bias, once (it is replicated: added on each rank before the sum it
would count ``model`` times).
"""

from __future__ import annotations

import torch

from .mesh import Mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, mesh: Mesh):
    """f: enter a column-parallel region (gradient summed over "model")."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh: Mesh):
    """g: leave a row-parallel region (forward summed over "model")."""
    return _ReduceFromModel.apply(x, mesh)


def row_parallel(params, x, mesh: Mesh):
    """``dense`` whose weight holds this rank's input columns: the partial
    products summed over the model group, then the whole bias."""
    y = reduce_from_model(torch.matmul(x, params["weight"].t()), mesh)
    b = params.get("bias")
    return y if b is None else y + b
