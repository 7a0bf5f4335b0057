#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, limits and metric readers are found by
name (``benchmark/core.py``). ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` reads its
per-layer metrics from spans and a profiler trace. Either way the
window's outputs are then compared with the plain reference
(``benchmark/reference``), each number compared is printed beside its
limit, and the last line of standard output is the result as JSON. The
run needs as many CUDA cards as the cell asks for, and exits with 2 and
no result without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


class Run:
    """One run of a cell: what the traffic module sets up and measures,
    and what the metric readers read."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic()

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def profile(self, fn):
        """``fn()`` under ``torch.profiler`` (the card's activity where
        there is one), read into a trace summary (``core.read_profile``)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from benchmark import core
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(core.MARK):
                fn()
                self.sync()
        return core.read_profile(torch, prof)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """(result, check lines, run) of one run of ``cell`` on ``device``."""
    import torch
    from benchmark import core

    run = Run(cell, seed, device)
    run.traffic.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    if trace:
        run.traffic.traced(run, run.profile)
    else:
        run.traffic.window(run, seconds)
    on_card = device.type == "cuda"
    run.peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    dev = (core.device_info(torch, cell.chips) if on_card else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    if trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = core.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = core.Checks(cell.limits)
    run.traffic.check(run, checks)
    result = {"correct": checks.ok(), "attempted": run.window["requests"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace and on_card:
        result["breakdown"] = core.breakdown(run.trace)
    if on_card:
        from ditto_tts_tpu_torch import kernels
        result["kernel_launches"] = dict(kernels.launches)
        result["card"] = core.power_limit()
    result["checks"] = checks.as_dict()
    return result, checks.lines(), run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import core
    cell = core.Cell(core.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), T_START)
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
