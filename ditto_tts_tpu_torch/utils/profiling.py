"""Tracing and profiling helpers (the JAX package's ``utils/profiling.py``,
SURVEY 5.1; the reference has none): named ranges that show in a trace, a
trace written to a directory, and a determinism check (the same inputs and
seed give bit-identical results; SURVEY 5.2's stand-in for race
detection).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable

import torch

from ..params import tree_leaves

# with annotate("train_step"): ... (a named range in the profiler's trace)
annotate = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the CPU and, where there is one, the card while the block
    runs; write a Chrome trace (``trace.json``) into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _host_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu()]
    return [t.detach().cpu() if isinstance(t, torch.Tensor)
            else torch.as_tensor(t) for _, t in tree_leaves(out)]


def check_determinism(fn: Callable[..., Any], *args, runs: int = 2) -> bool:
    """True iff ``fn(*args)`` gives bit-identical results over ``runs``
    calls (every leaf of nested dicts / lists / tuples of tensors)."""
    first = _host_leaves(fn(*args))
    for _ in range(runs - 1):
        again = _host_leaves(fn(*args))
        if len(again) != len(first) or not all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) for a, b in zip(first, again)):
            return False
    return True
