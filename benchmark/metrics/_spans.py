"""The program's own spans (``ditto_tts_tpu_torch/utils/profiling.py``)
over the cell's own traffic, for the per-layer metrics that read them.

Computed once per traced run, on the first read, and kept on ``run`` as
``run.program_spans``. After the benchmark's traced phase it drives the
cell's traffic again (``_request`` of ``serve_closed``, ``_step`` of
``train_step``) for ``trace_requests`` requests or ``trace_steps`` steps,
twice:

  (a) recording on and no profiler: the spans' host durations, which a
      profiler would inflate;
  (b) recording on under ``torch.profiler`` (the CPU and the card): each
      device operation goes to the innermost span whose range holds the
      host launch call that shares the operation's correlation id. A span
      opens a ``record_function`` range of its name while a profiler runs;
      those ranges, not the spans' own ``time.time_ns()`` readings, give
      the spans' extent here, so launch calls and spans are read off one
      clock. Device times are compared only with each other: on the card
      (torch 2.11) the profiler's device timestamps drifted from its host
      clock by several ms a second in some processes. A span whose range
      is missing leaves the device readers with nothing.

``run.outputs``, ``run.window``, ``run.trace``, ``run.spans`` and the
program's launch counters are left as they were, so the other readers and
the comparison read what they read without it. Nothing is computed where
the program records no spans (it has no ``recording``) or the traffic
kind has no request or step to drive; each reader then returns None, as
a device reader does where no device operation was traced (the CPU).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..core import _merge

RUNTIME = re.compile(r"cu(da)?[A-Z]")


def phases(run) -> Optional[dict]:
    """``{"host": spans of (a), "spans": spans of (b) with their ranges'
    start_ns and end_ns, "ops": {span index in (b): [(name, start_ns,
    end_ns)]}, "offset_ns": each range's start less its span's}``, or
    None."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _measure(run)
    return run.program_spans


def _traffic_loop(run):
    traffic = run.traffic
    if hasattr(traffic, "_request"):
        n = run.cell.mix["trace_requests"]

        def drive():
            for i in range(n):
                traffic._request(run, i)
                run.sync()
    elif hasattr(traffic, "_step"):
        n = run.cell.mix["trace_steps"]

        def drive():
            for _ in range(n):
                traffic._step(run)
                run.sync()
    else:
        return None
    return drive


def _measure(run) -> Optional[dict]:
    try:
        from ditto_tts_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    drive = _traffic_loop(run)
    if drive is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ditto_tts_tpu_torch import kernels
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    counted = dict(kernels.launches)
    try:
        with recording() as rec:
            drive()
        host = rec.spans()
        with recording() as rec:
            with profile(activities=acts) as prof:
                drive()
        spans = rec.spans()
        launches, ops, ranges = read_kineto(
            torch, prof.profiler.kineto_results, {s["name"] for s in spans})
    finally:
        kernels.launches.update(counted)
    timed = on_ranges(spans, ranges)
    if timed is None:
        return {"host": host, "spans": spans, "ops": {}, "offset_ns": []}
    return {"host": host, "spans": timed,
            "ops": attribute(timed, launches, ops),
            "offset_ns": [t["start_ns"] - s["start_ns"]
                          for t, s in zip(timed, spans)]}


def read_kineto(torch, results, names=()):
    """(the start of each host launch call by correlation id, the device
    operations as (name, start_ns, end_ns, correlation id), the host ranges
    named in ``names`` as (name, start_ns, end_ns)) from a profiler's Kineto
    results, in Unix-epoch ns (some builds stamp events from the trace's
    start). A launch call is a CUDA API call (``cuda*``, ``cu*``); a
    kernel's correlation id is its launch call's. Ranges that
    the profiler also draws on the device's timeline, and other
    annotations, are not operations."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(results.events())
    t0 = results.trace_start_ns()
    shift = t0 if events and max(e.start_ns() for e in events) < t0 else 0
    launches: Dict[int, int] = {}
    ops, ranges = [], []
    for e in events:
        name = e.name()
        noted = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == cuda:
            if not (noted or name in names
                    or name.startswith("Activity Buffer")):
                ops.append((name, e.start_ns() + shift, e.end_ns() + shift,
                            e.correlation_id()))
        elif name in names:
            ranges.append((name, e.start_ns() + shift, e.end_ns() + shift))
        elif RUNTIME.match(name):
            launches[e.correlation_id()] = e.start_ns() + shift
    return launches, ops, ranges


def on_ranges(spans: List[dict], ranges) -> Optional[List[dict]]:
    """The spans with the start and end of the profiler's range of each (the
    k-th range of a name is the k-th span of that name, in order of start),
    or None where a name's ranges and spans do not pair up."""
    by_name: Dict[str, list] = {}
    for r in sorted(ranges, key=lambda r: (r[1], -r[2])):
        by_name.setdefault(r[0], []).append(r)
    seen: Dict[str, int] = {}
    out = []
    for s in spans:
        k = seen.get(s["name"], 0)
        seen[s["name"]] = k + 1
        got = by_name.get(s["name"], [])
        if k >= len(got):
            return None
        out.append(dict(s, start_ns=got[k][1], end_ns=got[k][2]))
    if any(len(v) != seen.get(n, 0) for n, v in by_name.items()):
        return None
    return out


def attribute(spans: List[dict], launches: Dict[int, int], ops) -> dict:
    """Each device operation under the innermost span whose [start_ns,
    end_ns] holds its launch call: ``{span index: [(name, start_ns,
    end_ns)]}``; those launched outside every span, or whose launch was not
    traced, under None."""
    timed = [(launches.get(c, float("inf")), name, s, e)
             for name, s, e, c in ops]
    timed.sort()
    order = sorted(range(len(spans)), key=lambda i: (spans[i]["start_ns"],
                                                     -spans[i]["end_ns"]))
    out: Dict[Optional[int], list] = {}
    stack: List[int] = []
    k = 0
    for at, name, s, e in timed:
        while k < len(order) and spans[order[k]]["start_ns"] <= at:
            i = order[k]
            while stack and spans[stack[-1]]["end_ns"] < spans[i]["start_ns"]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and spans[stack[-1]]["end_ns"] < at:
            stack.pop()
        out.setdefault(stack[-1] if stack else None, []).append((name, s, e))
    return out


def _subtree(spans: List[dict], root: int) -> set:
    inside = {root}
    for i in range(root + 1, len(spans)):
        if spans[i]["parent"] in inside:
            inside.add(i)
    return inside


def _named_ops(p: dict, name: str):
    """Per span named ``name`` in (b), the operations of its subtree."""
    spans, ops = p["spans"], p["ops"]
    return [[o for j in sorted(_subtree(spans, i)) for o in ops.get(j, ())]
            for i, s in enumerate(spans) if s["name"] == name]


def host_ms(run, name: str) -> Optional[float]:
    """The mean host duration of the spans named ``name`` in (a), in ms."""
    p = phases(run)
    if not p:
        return None
    d = [s["end_ns"] - s["start_ns"] for s in p["host"] if s["name"] == name]
    return sum(d) / len(d) / 1e6 if d else None


def kernels_per_span(run, name: str) -> Optional[float]:
    """Device kernels (copies and fills left out, as ``core.kernel_ops``)
    under each span named ``name`` in (b), on average."""
    p = phases(run)
    if not p:
        return None
    per = _named_ops(p, name)
    n = sum(1 for ops in per for o in ops
            if not o[0].startswith(("Memcpy", "Memset")))
    return n / len(per) if n else None


def idle_share(run, name: str) -> Optional[float]:
    """Over the spans named ``name`` in (b): of the device interval from
    each one's first to its last operation, the share no operation of it
    covers, summed over the spans, in %."""
    p = phases(run)
    if not p:
        return None
    span_ns = idle_ns = 0
    for ops in _named_ops(p, name):
        if not ops:
            continue
        lo, hi = min(o[1] for o in ops), max(o[2] for o in ops)
        busy = sum(e - s for s, e in _merge([(o[1], o[2]) for o in ops]))
        span_ns += hi - lo
        idle_ns += hi - lo - busy
    return 100.0 * idle_ns / span_ns if span_ns > 0 else None
