"""PyTorch + CUDA port of the DiTTo serving chain for one NVIDIA H100.

The JAX package ``ditto_tts_tpu`` is the reference; this package imports
``torch`` and never ``jax`` or ``ditto_tts_tpu``. Every Pallas kernel on the
serving path is a hand-written CUDA kernel under ``csrc/`` (built at first
use by ``kernels.py``); each wrapper takes its plain PyTorch version only
for a tensor on the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """Entry points run on ``cuda`` unless the caller passes ``"cpu"``.

    Raises when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
