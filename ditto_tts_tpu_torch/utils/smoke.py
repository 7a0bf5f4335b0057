"""Information-preserving re-init of random smoke models (the JAX
package's ``utils/smoke.py``).

The default random init of deep conv stacks (the codec's SEANet, BigVGAN)
is contractive: through ~10 layers the input-dependent signal falls ~300x
below the layers' own bias floor, so a random codec maps every input to
the same codes and a random vocoder renders nearly input-independent
audio. Smoke runs that stand in for trained weights must preserve
information, or an evaluation measures nothing.

``orthogonal_reinit`` redraws every weight matrix or kernel as a scaled
(semi-)orthogonal matrix (rows of a QR factor); ``gain`` ~1.2 makes up for
the activations' contraction. Biases and 1-D leaves (norm scales, snake
alpha / beta) stay. One numpy generator draws the leaves in JAX's flatten
order (``params.tree_paths``: sorted dict keys, then list indices), so a
seed gives the JAX package's matrices bit for bit. ``scripts/evaluate.py
--smoke-ortho`` applies it to random codec and vocoder trees, never to
loaded weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import tree_paths, tree_unflatten


def orthogonal_reinit(tree, *, gain: float = 1.2, seed: int = 0):
    """``tree`` with every leaf of ndim >= 2 replaced by gain times a
    (semi-)orthogonal matrix of its shape (as [dim0, rest]), in the leaf's
    dtype and on its device."""
    rng = np.random.default_rng(seed)
    out = []
    for _, leaf in tree_paths(tree):
        if leaf.ndim < 2:
            out.append(leaf)
            continue
        rows, cols = leaf.shape[0], int(np.prod(leaf.shape[1:]))
        m = rng.standard_normal((max(rows, cols), min(rows, cols)))
        q, _ = np.linalg.qr(m)
        w = q[:rows, :cols] if rows >= cols else q[:cols, :rows].T
        out.append(torch.from_numpy((gain * w).reshape(leaf.shape)).to(
            dtype=leaf.dtype, device=leaf.device))
    return tree_unflatten(tree, out)
