"""The flow-matching sampler of F5-TTS (``model/cfm.py:sample``): Euler
steps of dy/dt = v(y, t) from y0 ~ N(0, I) at t = 0 to t = 1, over the
grid

  t_i = i / K,  i = 0..K,   swayed:  t + s (cos(pi t / 2) - 1 + t)

(sway sampling, s = -1 crowds the early steps; F5's default), each step
y <- y + (t_{i+1} - t_i) v(y, t_i), in fp32 as F5's ``torchdiffeq``
Euler solver does. The grid is computed on the CPU in fp32, as F5
computes it. Each step is a ``sampler.step`` span (attr ``step``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..utils.profiling import span


def sway_times(steps: int, sway_coef: Optional[float]) -> torch.Tensor:
    """The K + 1 times [0, ..., 1], fp32 on the CPU."""
    t = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32)
    if sway_coef is not None:
        t = t + sway_coef * (torch.cos(math.pi / 2 * t) - 1.0 + t)
    return t


def euler_sample(model_fn: Callable, y0, times: torch.Tensor):
    """y at t = times[-1] from y0 at times[0]; ``model_fn(y, t)`` with t
    [B] on y's device gives the velocity."""
    y = y0
    tv = times.to(y0.device)[:, None].expand(-1, y0.shape[0])
    for i in range(times.shape[0] - 1):
        with span("sampler.step", step=i):
            dt = float(times[i + 1] - times[i])
            y = y + dt * model_fn(y, tv[i])
    return y
