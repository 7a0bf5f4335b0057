"""Checkpoints in the JAX package's format (its ``train/checkpoint.py``):
one compressed ``.npz`` keyed by tree path, plus ``.json`` metadata.

A key joins a leaf's path with ``//``: ``k:<key>`` for a dict key or a
named-tuple field, ``i:<n>`` for a list or tuple index, so a DiTTo train
state writes ``k:params//k:blocks//i:0//k:attn//...``,
``k:opt_state//i:0//k:count`` / ``k:mu`` / ``k:nu`` and ``k:step``, letter
for letter as JAX's ``_flatten`` does, with the same dtypes (count and
step int32). A checkpoint written by either package restores in the other.
No pickle: ``convert_torch_checkpoint`` reads reference ``.pth`` files
with ``torch.load(weights_only=True)``.

Under a (data, model) mesh ``save_checkpoint`` is collective: given the
mesh and the state's specs (``parallel/train_setup.py``), every rank joins
the gather of the full state and only rank 0 writes (JAX's
``process_index() != 0`` guard), so a file written by a tensor-parallel
run has JAX's keys and full shapes and loads unchanged into one process,
of either package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import gather_tree
from ..params import tree_paths, tree_unflatten

_SEP = "//"


def _key(path) -> str:
    """A ``tree_paths`` path as JAX's ``_path_str``: ``k:`` before a dict
    key, ``i:`` before a sequence index."""
    return _SEP.join(f"i:{p}" if isinstance(p, int) else f"k:{p}"
                     for p in path)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in tree_paths(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Nested dicts and lists from path keys (the JAX ``_unflatten``)."""
    root: Any = None

    def insert(key: str, value):
        nonlocal root
        parts = key.split(_SEP)
        if root is None:
            root = [] if parts[0].startswith("i:") else {}
        node = root
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            if part.startswith("i:"):
                idx = int(part[2:])
                while len(node) <= idx:
                    node.append(None)
                if last:
                    node[idx] = value
                else:
                    if node[idx] is None:
                        node[idx] = ([] if parts[i + 1].startswith("i:")
                                     else {})
                    node = node[idx]
            else:
                k = part[2:]
                if last:
                    node[k] = value
                else:
                    if k not in node or node[k] is None:
                        node[k] = ([] if parts[i + 1].startswith("i:")
                                   else {})
                    node = node[k]

    for key in sorted(flat):
        insert(key, flat[key])
    return root


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def save_checkpoint(path: str, state: Any,
                    metadata: Optional[Dict] = None, *, mesh=None,
                    specs=None) -> None:
    """Write the state tree (tensors or arrays, any device) to ``path``
    (.npz) and ``metadata`` to ``path`` with ``.json``. With a ``mesh``
    (and the state's ``specs``) every rank must call it: the full state is
    gathered, rank 0 writes, and all return once the file is there."""
    if mesh is not None:
        state = gather_tree(mesh, state, specs)
    if mesh is None or mesh.rank == 0:
        flat = _flatten(state)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(_npz_path(path), **flat)
        if metadata is not None:
            with open(_meta_path(path), "w") as f:
                json.dump(metadata, f)
    if mesh is not None:
        mesh.barrier()


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(_npz_path(path)) as z:
        return {k: z[k] for k in z.files}


def load_metadata(path: str) -> Optional[Dict]:
    """The ``.json`` metadata saved beside ``path``, or None."""
    if not os.path.exists(_meta_path(path)):
        return None
    with open(_meta_path(path)) as f:
        return json.load(f)


def load_checkpoint(path: str) -> Tuple[Any, Optional[Dict]]:
    """(tree of numpy arrays, metadata or None), as JAX's returns them."""
    return _unflatten(_read(path)), load_metadata(path)


def restore_into(template: Any, path: str) -> Any:
    """Each stored array placed at the template leaf with the same path,
    as a tensor of the template leaf's dtype on its device (the CPU for a
    leaf on the ``meta`` device: a template of shapes alone); the
    template's dicts and lists keep their structure. Missing or extra paths
    raise KeyError, a shape mismatch ValueError (the JAX
    ``restore_into``)."""
    flat = _read(path)
    items = list(tree_paths(template))
    paths = [_key(p) for p, _ in items]
    missing = [p for p in paths if p not in flat]
    extra = sorted(set(flat) - set(paths))
    if missing or extra:
        raise KeyError(
            f"checkpoint/template structure mismatch for {path}: "
            f"missing {missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"extra {extra[:5]}{'...' if len(extra) > 5 else ''}")
    values = []
    for p, (_, leaf) in zip(paths, items):
        arr = flat[p]
        like = leaf if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.asarray(leaf))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch at {p}: checkpoint "
                             f"{arr.shape} vs template {tuple(like.shape)}")
        values.append(torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=like.dtype, device="cpu" if like.device.type == "meta"
            else like.device))
    return tree_unflatten(template, values)


def latest_checkpoint(checkpoint_dir: str,
                      prefix: str = "checkpoint") -> Optional[str]:
    """The highest-epoch ``{prefix}_epoch_{n}.npz`` in the directory."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best, best_n = None, -1
    pat = re.compile(rf"{re.escape(prefix)}_epoch_(\d+)\.npz$")
    for name in os.listdir(checkpoint_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_n:
            best_n = int(m.group(1))
            best = os.path.join(checkpoint_dir, name)
    return best


def convert_torch_checkpoint(pth_path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (a dict with ``model_state_dict``, or a bare
    state dict) as a flat numpy state dict for the importers."""
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}
