"""Local pretrained-weight loading (the JAX package's
``utils/weights.py``): a ``.safetensors`` file, a directory of them (or of
``.bin`` files), or a torch ``.pt`` / ``.pth`` / ``.bin`` file, as a flat
numpy state dict for the importers (``codec/encodec.py``,
``text/gpt2.py``, ``text/byt5.py``). Nothing is downloaded.

``safetensors`` is imported only when a ``.safetensors`` path is given;
torch's pickle formats go through ``train.checkpoint.
convert_torch_checkpoint`` (``weights_only=True``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A state dict from a .safetensors file, a directory of them (else of
    .bin files), or a torch .pt / .pth / .bin file."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            files = sorted(glob.glob(os.path.join(path, "*.bin")))
        sd: Dict[str, np.ndarray] = {}
        for f in files:
            sd.update(load_state_dict(f))
        if not sd:
            raise FileNotFoundError(f"no weight files under {path}")
        return sd
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        try:
            return dict(load_file(path))
        except TypeError:
            # a dtype numpy lacks (bf16): through torch, as fp32
            from safetensors.torch import load_file as load_torch
            return {k: v.float().numpy()
                    for k, v in load_torch(path).items()}
    from ..train.checkpoint import convert_torch_checkpoint
    return convert_torch_checkpoint(path)
