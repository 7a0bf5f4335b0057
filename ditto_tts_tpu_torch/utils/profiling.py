"""Tracing and profiling (the JAX package's ``utils/profiling.py``, SURVEY
5.1; the reference has none): spans that the program records where its
work happens, a trace of a block written to a directory, and a
determinism check (the same inputs and seed give bit-identical results;
SURVEY 5.2's stand-in for race detection).

Spans. ``with span(name, **attrs):`` marks a stretch of the program. The
serving chains record ``request`` (the root: batch, frames), ``encode``,
``slp``, ``sampler`` (the whole DDPM or DDIM loop; graph, "captured" or
"eager"; glue, "fused" or "eager", which the DiT forward adds) over ``sampler.capture`` (the capture of the step's CUDA graph,
where there is one) and one ``sampler.step`` a step (step), ``vq``,
``codec_decode``, ``mel`` and ``vocoder`` (the F5 chain: ``request`` over
``mel``, ``text_encode``, ``sampler`` and ``vocoder``; the VALL-E chain:
``request`` over ``encode``, ``ar`` (graph) with ``ar.prefill``,
``ar.capture`` and one ``ar.step`` a decoded token (step), ``nar`` with one
``nar.stage`` a stage (stage, 2..8), and ``codec_decode``); the train steps
``train.step`` over ``train.place``, ``train.encode`` (DiTTo),
``train.forward``, ``train.backward`` and ``train.optimizer``, with a
``train.allreduce`` around each mean over a data group of several ranks.

Recording is off unless a ``recording()`` block is open. Off, ``span``
tests one module variable and returns the shared object ``OFF``, whose
``__enter__`` and ``__exit__`` do nothing: no span object, no clock read,
no profiler range. On, each span keeps its name, its start and end from
``time.time_ns()`` (the Unix-epoch clock on which ``torch.profiler``
stamps host events), the index
of its parent, a request id that every span under one root shares, and
its attrs; while a ``torch.profiler`` records, it also opens a
``record_function`` range of its name, which the Chrome trace shows.
``annotate(name, **attrs)`` adds attrs to the innermost open span of
that name, for what a callee decides after its caller opened the span.
``count(name, value)`` adds to a counter of the request whose span is
open (VALL-E's ``kv_cache_bytes``, the cache allocated, and
``ar_tokens``, the tokens decoded). Spans and counters stay in memory:
``recording().spans()`` and ``.counters()`` return them as dicts.
Each thread keeps its own stack of open spans; a span opened on a thread
with none open is a root.

``trace(log_dir)`` is the operator's tool: it profiles the block with
recording on and writes ``trace.json`` (Chrome trace) and ``spans.json``
(one object per span) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..params import tree_leaves


class _Off:
    """The span that is returned while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

# the open recording; None while recording is off (the one test ``span``
# makes when off)
_recorder: Optional["Recorder"] = None


def span(name: str, **attrs):
    """A context manager that records ``name`` over its block while a
    ``recording()`` is open, and ``OFF`` otherwise."""
    if _recorder is None:
        return OFF
    return _Span(_recorder, name, attrs)


def count(name: str, value) -> None:
    """Adds ``value`` to counter ``name`` of the request whose span is open
    on this thread (None outside every span); nothing while recording is
    off."""
    if _recorder is not None:
        _recorder._count(name, value)


def annotate(name: str, **attrs):
    """Adds ``attrs`` to the innermost span called ``name`` that is open on
    this thread; nothing while recording is off or no such span is open."""
    if _recorder is not None:
        _recorder._annotate(name, attrs)


class Recorder:
    """The spans of one ``recording()`` block, in the order they opened."""

    def __init__(self):
        # [name, start_ns, end_ns, parent, request, attrs] a span
        self._spans: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = 0
        self._counters: Dict[tuple, float] = {}

    def _count(self, name: str, value):
        stack = getattr(self._local, "stack", None)
        with self._lock:
            request = self._spans[stack[-1]][4] if stack else None
            key = (name, request)
            self._counters[key] = self._counters.get(key, 0) + value

    def counters(self) -> List[Dict[str, Any]]:
        """Every counter as ``{"name", "request", "value"}``."""
        with self._lock:
            return [{"name": n, "request": r, "value": v}
                    for (n, r), v in self._counters.items()]

    def _open(self, name: str, attrs: Dict[str, Any]) -> int:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            parent = stack[-1] if stack else None
            if parent is None:
                request = self._requests
                self._requests += 1
            else:
                request = self._spans[parent][4]
            index = len(self._spans)
            self._spans.append([name, time.time_ns(), None, parent, request,
                                attrs])
        stack.append(index)
        return index

    def _annotate(self, name: str, attrs: Dict[str, Any]):
        with self._lock:
            for index in reversed(getattr(self._local, "stack", ())):
                if self._spans[index][0] == name:
                    self._spans[index][5].update(attrs)
                    return

    def _close(self, index: int):
        self._spans[index][2] = time.time_ns()
        self._local.stack.pop()

    def spans(self) -> List[Dict[str, Any]]:
        """Every span as ``{"name", "start_ns", "end_ns", "parent",
        "request", "attrs"}``; ``parent`` is an index into this list (None
        for a root) and ``end_ns`` is None while the span is open."""
        with self._lock:
            rows = [list(s) for s in self._spans]
        return [{"name": n, "start_ns": s, "end_ns": e, "parent": p,
                 "request": r, "attrs": dict(a)}
                for n, s, e, p, r, a in rows]


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_index", "_range")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self):
        self._index = self._rec._open(self._name, self._attrs)
        self._range = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec._close(self._index)
        return False


@contextlib.contextmanager
def recording():
    """Record spans while the block runs; yields the ``Recorder``. A
    recording opened inside another takes the spans until it closes."""
    global _recorder
    prev, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the CPU and, where there is one, the card while the block
    runs, with spans recorded; write the Chrome trace (``trace.json``, the
    spans among its ranges) and the spans (``spans.json``) into
    ``log_dir``. Yields the ``Recorder``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec:
        with torch.profiler.profile(activities=acts) as prof:
            yield rec
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(rec.spans(), f)


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
