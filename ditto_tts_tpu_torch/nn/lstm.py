"""Multi-layer LSTM for the EnCodec bottleneck.

The JAX package's ``nn/lstm.py`` keeps torch.nn.LSTM's weight layout and
gate order (i, f, g, o), so the weights go as they are to the operator
``nn.LSTM`` runs (``torch.lstm``; cuDNN on the card).
"""

from __future__ import annotations

import torch


def lstm(params_layers, x):
    """Stacked LSTM, zero initial state. x: [T, B, in] -> [T, B, H]."""
    hidden = params_layers[0]["weight_hh"].shape[1]
    n = len(params_layers)
    flat = [p[name] for p in params_layers
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    h0 = x.new_zeros((n, x.shape[1], hidden))
    out, _, _ = torch.lstm(x, (h0, h0), flat, True, n, 0.0, False, False,
                           False)
    return out
