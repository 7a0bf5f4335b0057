"""GPT2 text conditioning: the raw ``wte`` lookup the DiT is fed.

The full GPT2 stack (the NAC alignment loss) belongs to the training port.
"""

from __future__ import annotations


def embed_tokens(params, ids):
    """Raw wte lookup: ids [B, St] -> [B, St, n_embd]."""
    return params["wte"]["weight"][ids]
