"""Throughput and latency: seconds of audio synthesized (or trained on) per
second per card (the JAX package's ``eval/throughput.py``; the reference
publishes no throughput, BASELINE.md).

A warm-up first, then the best of ``iters`` host-clock runs, each fenced
by ``torch.cuda.synchronize`` on the result's device (PyTorch returns
before the card finishes, so an unfenced time measures the enqueue). A
result on the CPU needs no fence and counts one device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from ..params import tree_leaves


def _fence(out) -> str:
    """Wait for ``out``'s device; returns its type ("cuda" or "cpu")."""
    leaves = [out] if isinstance(out, torch.Tensor) else \
        [t for _, t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    cuda = [t for t in leaves if t.is_cuda]
    if cuda:
        torch.cuda.synchronize(cuda[0].device)
        return "cuda"
    return "cpu"


def _best(run: Callable, iters: int, warmup: int) -> Tuple[float, str]:
    kind = "cpu"
    for _ in range(warmup):
        kind = _fence(run())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        kind = _fence(run())
        best = min(best, time.perf_counter() - t0)
    return best, kind


def _devices(kind: str) -> int:
    return max(torch.cuda.device_count(), 1) if kind == "cuda" else 1


def time_fn(fn: Callable, *args, iters: int = 3, warmup: int = 1) -> float:
    """The least wall-clock seconds of ``fn(*args)`` over ``iters`` fenced
    calls, after ``warmup`` calls."""
    return _best(lambda: fn(*args), iters, warmup)[0]


def synthesis_throughput(fn: Callable, args, *, batch: int,
                         utterance_seconds: float,
                         iters: int = 3) -> Dict[str, float]:
    """Audio-seconds per second (per card) and latency of a synthesize
    function."""
    dt, kind = _best(lambda: fn(*args), iters, 1)
    audio = batch * utterance_seconds
    return {
        "seconds_per_batch": dt,
        "audio_seconds_per_second": audio / dt,
        "audio_seconds_per_second_per_chip": audio / dt / _devices(kind),
        "rtf": dt / audio,      # real-time factor (lower is better)
    }


def train_step_throughput(step_fn: Callable, state, frozen, batch,
                          generator=None, *, batch_size: int,
                          utterance_seconds: float,
                          iters: int = 3) -> Dict[str, float]:
    """Audio-seconds of training data per second per card; the step is
    functional (it returns a new state), so every call starts from
    ``state``."""
    dt, kind = _best(lambda: step_fn(state, frozen, batch, generator),
                     iters, 1)
    return {
        "seconds_per_step": dt,
        "audio_seconds_per_second_per_chip":
            batch_size * utterance_seconds / dt / _devices(kind),
    }
