"""GPT2 text conditioning: the raw ``wte`` lookup the DiT is fed, and the
``gelu_new`` activation that ByT5's feed-forward shares.

The full GPT2 stack (the NAC alignment loss) belongs to the training port.
"""

from __future__ import annotations

import math

import torch


def embed_tokens(params, ids):
    """Raw wte lookup: ids [B, St] -> [B, St, n_embd]."""
    return params["wte"]["weight"][ids]


def gelu_new(x):
    """HF 'gelu_new', the tanh approximation, computed in fp32 and cast
    back to x's type."""
    c = math.sqrt(2.0 / math.pi)
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(c * (xf + 0.044715 * torch.pow(xf, 3.0))))
    return y.to(x.dtype)
