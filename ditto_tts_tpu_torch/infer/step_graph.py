"""The DiT forward of one denoising step as one CUDA graph: captured once
per sampler call, replayed for every step (the JAX sampler's ``lax.scan``,
which eager PyTorch lacks: eager, a step is ~930 launches, and at small
batches the host issuing them takes longer than the card running them).

``engages(x)`` says whether the graph is used: ``x`` on a CUDA device,
grad mode off (the serving entry points run under ``inference_mode``) and
no capture already under way. Elsewhere, on the CPU and under grad, the
step is the eager call, unchanged.

``capture(forward, x, t, key)`` returns ``model_fn(x, t)``, which copies
``x`` and ``t`` into the graph's input buffers, replays the graph on the
current stream and returns the graph's output buffer. The next replay
overwrites that buffer: the caller consumes it before the next call (the
DDPM and DDIM updates do), and nothing holds it across steps. The graph
reads every other tensor ``forward`` closes over (the cast blocks, cross
K/V, text embedding and RoPE tables of the request) in place, so those
outlive ``model_fn``, and the graph is captured anew for every request.
The replayed kernels are the eager step's kernels, in its order, on its
shapes and alignments, so a replay gives the eager step's bits.

Per CUDA device and for the whole process (one registry, behind a lock:
CUDA allows one capture at a time) there is one capture stream and one
graph memory pool, so requests reuse the pool's memory, and the set of
``key``s already run. A ``key`` not run yet in the process (the caller's
description of what ``forward`` computes: shapes, types, configuration)
is first run eagerly on the capture stream, outside the capture, so that
lazy initialisation (cuBLAS workspaces, kernel loading) does not fall
inside it; that eager call is the request's step 0, and ``model_fn``
returns its result for its first call when that call passes ``x`` itself.
The last graph captured on a device is kept, never replayed, so that the
pool always has a graph holding it between requests.

Launch counts (``kernels.launches``): the wrappers count at Python call
time, so the capture would count one forward and a replay nothing.
``capture`` takes back what the capture counted and ``model_fn`` adds it
at every replay, so a request counts what the eager loop counts.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable

import torch

from .. import kernels

_lock = threading.Lock()
_devices: Dict[int, "_Device"] = {}


class _Device:
    """One device's capture stream, graph pool, keys run and last graph."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.warm: set = set()
        self.last = None


def engages(x) -> bool:
    """Whether a step on ``x`` is captured and replayed: ``x`` on a CUDA
    device, grad mode off and no capture under way on the current
    stream."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


def capture(forward: Callable, x: torch.Tensor, t: torch.Tensor,
            key: Hashable) -> Callable:
    """``model_fn(x, t)`` replaying ``forward(x, t)`` as one CUDA graph (see
    the module docstring). ``x`` and ``t`` are the first step's inputs;
    their shapes, types and device are every step's."""
    with _lock:
        dev = _devices.get(x.device.index)
        if dev is None:
            dev = _devices[x.device.index] = _Device(x.device)
        main = torch.cuda.current_stream(x.device)
        x_in, t_in = torch.empty_like(x), torch.empty_like(t)
        key = (key, tuple(x.shape), x.dtype, tuple(t.shape), t.dtype)
        first = None
        dev.stream.wait_stream(main)
        with torch.cuda.stream(dev.stream):
            if key not in dev.warm:
                first = forward(x, t)
                dev.warm.add(key)
            graph = torch.cuda.CUDAGraph()
            counted = dict(kernels.launches)
            try:
                graph.capture_begin(pool=dev.pool)
                try:
                    out = forward(x_in, t_in)
                finally:
                    graph.capture_end()
            finally:
                per_replay = {k: n - counted[k]
                              for k, n in kernels.launches.items()
                              if n != counted[k]}
                kernels.launches.update(counted)
        main.wait_stream(dev.stream)
        dev.last = graph

    def model_fn(x_now, t_now):
        nonlocal first
        if first is not None and x_now is x:
            done, first = first, None
            return done
        first = None
        x_in.copy_(x_now)
        t_in.copy_(t_now)
        graph.replay()
        for k, n in per_replay.items():
            kernels.launches[k] += n
        return out

    return model_fn
