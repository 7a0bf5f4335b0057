"""Sharding rules: parameter paths to specs (the JAX package's
``parallel/sharding.py``), and the slicing and gathering they imply.

The rule tables are JAX's, letter for letter, with a spec written as a
tuple of axis names (``("model", None)`` for ``P("model", None)``, ``()``
for ``P()``); first match wins over paths like
``blocks/3/attn/in_proj_weight``. Megatron pairs: in_proj and mlp_fc1 /
gate hold a share of the output features (column-parallel), out_proj and
mlp_fc2 a share of the input features (row-parallel); GPT2's HF-layout
([in, out]) matmuls take the transposed specs; everything else is
replicated.

``shard_tree`` returns this rank's slice of each full tensor, and
``gather_tree`` (collective over the sharded axes' groups) the full tensors
back. A packed projection (an MHA's ``in_proj_*``, GPT2's ``c_attn/*``:
q, k and v stacked along the sharded axis) is split per part, so rank r
holds heads [r*nh/M, (r+1)*nh/M) of q, of k and of v each; JAX's
``P("model", None)`` on the stacked rows would hand rank 0 of 2 all of q
and half of k, which GSPMD reshards but an explicit layer cannot use.
``gather_tree`` rebuilds the stacked order, so a gathered tree has JAX's
layout.

Attention that cannot split by heads stays whole on every rank of the
model group while its MLP still shards (``whole_attention``): when the
heads do not divide over the model axis (the reference's trained DiT has
one head of 768, the SLP one of 1472) and, under ``ref_compat``, the DiT's
self-attention, which has no out_proj to end the pair. The numbers equal
JAX's, whose GSPMD program computes the same function.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import torch

from .mesh import Mesh

# (path regex, spec) -- first match wins
_DIT_RULES = [
    (r"attn/in_proj_weight$", ("model", None)),
    (r"attn/in_proj_bias$", ("model",)),
    (r"attn/out_proj/weight$", (None, "model")),
    (r"attn/out_proj/bias$", ()),
    (r"(mlp_fc1|gate)/weight$", ("model", None)),
    (r"(mlp_fc1|gate)/bias$", ("model",)),
    (r"mlp_fc2/weight$", (None, "model")),
    (r"mlp_fc2/bias$", ()),
]

# the SLP's post-LN decoder (nn/transformer.py layout)
_SLP_RULES = [
    (r"(self_attn|cross_attn)/in_proj_weight$", ("model", None)),
    (r"(self_attn|cross_attn)/in_proj_bias$", ("model",)),
    (r"out_proj/weight$", (None, "model")),
    (r"out_proj/bias$", ()),
    (r"linear1/weight$", ("model", None)),
    (r"linear1/bias$", ("model",)),
    (r"linear2/weight$", (None, "model")),
    (r"linear2/bias$", ()),
]

_GPT2_RULES = [
    (r"c_attn/weight$", (None, "model")),
    (r"c_attn/bias$", ("model",)),
    (r"attn/c_proj/weight$", ("model", None)),
    (r"mlp/c_fc/weight$", (None, "model")),
    (r"mlp/c_fc/bias$", ("model",)),
    (r"mlp/c_proj/weight$", ("model", None)),
]

# q, k and v stacked along the sharded axis
_PACKED = re.compile(r"(in_proj_(weight|bias)|c_attn/(weight|bias))$")
# an attention's projections
_ATTN_PROJ = re.compile(r"(in_proj_(weight|bias)|out_proj/weight)$")


def map_tree(fn, tree, specs=None, path: str = ""):
    """``fn(leaf, spec, path)`` over ``tree``'s leaves (dicts and lists;
    paths like ``blocks/3/attn/in_proj_weight``), with the spec tree
    ``specs`` (or None) walked in step."""
    def sub(key):
        return None if specs is None else specs[key]

    def join(key):
        return f"{path}/{key}" if path else str(key)

    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, sub(k), join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, sub(i), join(i)) for i, v in enumerate(tree)]
    return fn(tree, specs, path)


def spec_for_path(path: str, rules) -> tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def tree_specs(params: Any, rules) -> Any:
    """The spec tree matching ``params``' structure."""
    return map_tree(lambda leaf, _, path: spec_for_path(path, rules), params)


def whole_attention(num_heads: int, model: int,
                    ref_compat: bool = False) -> Optional[str]:
    """The path regex of the attention whose projections stay whole on
    every rank of the model group: every attention when ``num_heads`` does
    not divide over ``model``; under ``ref_compat`` the self-attention
    (``blocks/i/attn``, not ``cross_attn``); None when all split."""
    if model <= 1:
        return None
    if num_heads % model:
        return r"attn/"
    return r"(^|/)attn/" if ref_compat else None


def _keep_whole(specs, params, pattern: Optional[str]):
    if pattern is None:
        return specs
    return map_tree(lambda _, spec, path: () if re.search(pattern, path)
                    and _ATTN_PROJ.search(path) else spec, params, specs)


def dit_param_specs(params: Any, cfg=None, model: int = 1) -> Any:
    """JAX's DiT rules; with the ``DiTConfig`` and the model axis, the
    attention that cannot split by heads kept whole (``whole_attention``)."""
    specs = tree_specs(params, _DIT_RULES)
    if cfg is None:
        return specs
    return _keep_whole(specs, params, whole_attention(
        cfg.num_heads, model, cfg.ref_compat))


def slp_param_specs(params: Any, cfg=None, model: int = 1) -> Any:
    """JAX's SLP decoder rules; with the ``SLPConfig`` and the model axis,
    attention whose heads do not divide kept whole."""
    specs = tree_specs(params, _SLP_RULES)
    if cfg is None:
        return specs
    return _keep_whole(specs, params, whole_attention(cfg.num_heads, model))


def gpt2_param_specs(params: Any) -> Any:
    return tree_specs(params, _GPT2_RULES)


def replicated_specs(params: Any) -> Any:
    return map_tree(lambda *_: (), params)


def is_sharded(specs: Any) -> bool:
    """Whether any spec in the tree names an axis."""
    if isinstance(specs, tuple):
        return any(specs)
    if isinstance(specs, Mapping):
        specs = specs.values()
    return any(is_sharded(s) for s in specs)


def _share(n: int, m: int, what: str) -> int:
    if n % m:
        raise ValueError(f"{what}: {n} does not split over {m}")
    return n // m


def _slice(leaf, spec, path: str, mesh: Mesh):
    parts = 3 if _PACKED.search(path) else 1
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        i = mesh.index(axis)
        part = _share(leaf.shape[dim], parts, path)
        s = _share(part, n, path)
        leaf = leaf.narrow(dim, i * s, s) if parts == 1 else torch.cat(
            [leaf.narrow(dim, j * part + i * s, s) for j in range(parts)],
            dim)
    return leaf


def _gather(leaf, spec, path: str, mesh: Mesh):
    parts = 3 if _PACKED.search(path) else 1
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        i = mesh.index(axis)
        s = _share(leaf.shape[dim], parts, path)
        shape = list(leaf.shape)
        shape[dim] *= n
        full = leaf.new_zeros(shape)
        for j in range(parts):
            full.narrow(dim, (j * n + i) * s, s).copy_(
                leaf.narrow(dim, j * s, s))
        # every other rank's share is zero here: the sum is exact
        leaf = mesh.all_reduce(full, axis)
    return leaf


def shard_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """This rank's slice of each full tensor (views where no copy is
    needed)."""
    return map_tree(lambda leaf, spec, path: _slice(leaf, spec, path, mesh),
                    tree, specs)


def gather_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """The full tensors of a sharded tree, on every rank (collective:
    every rank of each sharded axis's group calls it in the same order)."""
    return map_tree(lambda leaf, spec, path: _gather(leaf, spec, path, mesh),
                    tree, specs)
