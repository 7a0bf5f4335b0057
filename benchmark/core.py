"""What every cell of the benchmark shares: finding a cell's files by name,
seeds, weights drawn on the device, the device's description, the
comparison's checks, the reading of a profiler trace, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is ``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/mixes/<traffic>.json`` (whose ``kind`` names the
generator ``benchmark/traffic/<kind>.py``), the limits of its comparison
``benchmark/limits/<workload>.json``, and each metric ``<family>[.<cells>]``
is read by ``benchmark/metrics/<family>.py``.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ditto_tts_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` with its files and metrics."""

    def __init__(self, bench: dict, name: str, bench_dir: Path = BENCH):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.config = _json(bench_dir / "configs" / f"{self.entry['config']}.json")
        self.mix = _json(bench_dir / "traffic" / "mixes"
                         / f"{self.entry['traffic']}.json")
        self.limits = _json(bench_dir / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def traffic(self):
        return importlib.import_module(f"benchmark.traffic.{self.mix['kind']}")


def reader(metric_name: str):
    """The module that reads metric ``<family>[.<suffix>]``."""
    return importlib.import_module(
        f"benchmark.metrics.{metric_name.split('.')[0]}")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed derived from the run's seed and a tag."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# weights drawn on the device
# ---------------------------------------------------------------------------

def draw_spec(torch, spec, seed: int, device):
    """Tensors for a leaf-spec tree ((shape, kind, scale) leaves: "u"
    uniform(-scale, scale), "n" normal(0, scale), "1" ones, "0" zeros),
    fp32 on ``device``, from one generator: one uniform and one normal
    draw for the whole tree, cut into leaves."""
    leaves = []

    def walk(node, path):
        if isinstance(node, tuple):
            leaves.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(spec, ())
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {"u": 0, "n": 0}
    for _, (shape, kind, _) in leaves:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    pools = {"u": torch.rand(sizes["u"], generator=gen, device=device),
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    used = {"u": 0, "n": 0}
    out = {}
    for path, (shape, kind, scale) in leaves:
        n = math.prod(shape)
        if kind == "u":
            t = (pools["u"][used["u"]:used["u"] + n] * (2 * scale) - scale)
        elif kind == "n":
            t = pools["n"][used["n"]:used["n"] + n] * scale
        else:
            t = torch.full((n,), 1.0 if kind == "1" else 0.0, device=device)
        if kind in used:
            used[kind] += n
        out[path] = t.view(shape)

    def build(node, path):
        if isinstance(node, tuple):
            return out[path]
        if isinstance(node, dict):
            return {k: build(node[k], path + (k,)) for k in node}
        return [build(v, path + (i,)) for i, v in enumerate(node)]

    return build(spec, ())


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

class Checks:
    """Numbers compared against their limits: a number passes where it is
    finite and at most its limit."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float):
        """Record a number; one that this cell gives no limit is not
        compared (a cell's limits file names what it compares)."""
        if name not in self.limits:
            return
        value = float(value)
        prev = self.values.get(name)
        if prev is None or not value <= prev:     # keep the worst (or NaN)
            self.values[name] = value

    def ok(self) -> bool:
        return all(n in self.values for n in self.limits) and all(
            math.isfinite(v) and v <= self.limits[n]
            for n, v in self.values.items())

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": self.limits.get(n)}
                for n, v in self.values.items()}

    def lines(self) -> List[str]:
        return [f"check {n}: {v!r} (limit {self.limits.get(n)!r})"
                for n, v in self.values.items()]


def rel_rms(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in float64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp(min=1e-300))


# ---------------------------------------------------------------------------
# the profiler trace
# ---------------------------------------------------------------------------

MARK = "benchmark_window"


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _launch_call(name: str) -> bool:
    return name.startswith(("cudaLaunch", "cuLaunch", "cudaGetDevice",
                            "cudaPeekAtLastError", "cudaGetLastError"))


def busy_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    return sum(e - s for s, e in _merge(intervals)) / 1e6


def read_profile(torch, prof) -> dict:
    """From a ``torch.profiler`` run around a window marked with
    ``record_function(MARK)``: every device operation as (name, start,
    end) in us, the window's span, the device's busy seconds (the union of
    the operations' intervals), and the idle gaps attributed to the host
    operation that spans each."""
    dev_t = torch.autograd.DeviceType.CUDA
    ops, host, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.name == MARK:          # the annotation, on either timeline
            if e.device_type != dev_t:
                window = (tr.start, tr.end)
        elif getattr(e, "is_user_annotation", False) or \
                e.name.startswith("Activity Buffer"):
            continue
        elif e.device_type == dev_t:
            ops.append((e.name, tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    if window is None:
        window = (min((s for _, s, _ in ops), default=0),
                  max((e for _, _, e in ops), default=0))
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    merged = _merge([(max(s, window[0]), min(e, window[1]))
                     for _, s, e in ops])
    gaps, prev = [], window[0]
    for s, e in merged + [[window[1], window[1]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # the innermost host operation open at each gap's midpoint: a sweep
    # over host operations by start with a stack of the open ones (runtime
    # launch calls are skipped: the operation that launches is the cause)
    host = sorted(h for h in host if not _launch_call(h[2]))
    by_host: Dict[str, float] = {}
    stack, i = [], 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host operation)"
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
    by_op: Dict[str, float] = {}
    for n, s, e in ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    return {"ops": ops, "busy_s": sum(e - s for s, e in merged) / 1e6,
            "window_s": (window[1] - window[0]) / 1e6,
            "by_op": by_op, "idle_by_host": by_host}


def breakdown(trace: dict) -> dict:
    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(trace["by_op"]),
            "idle_gaps": top(trace["idle_by_host"])}


def kernel_ops(trace: dict):
    """The device operations that are kernels (not copies or fills)."""
    return [o for o in trace["ops"]
            if not o[0].startswith(("Memcpy", "Memset"))]
