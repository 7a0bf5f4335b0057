#!/usr/bin/env python3
"""The readings the limits of a serving cell are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--faults] [--out readings.jsonl]

For each seed: one run of the cell (a window of one request) gives the
program's numbers, the lower readings; then the control, the plain
reference in the precision below each part's stated one
(``reference.precision.control_of``), is put in the program's place for
the same request and judged by the same comparison, which gives the upper
readings (the traffic module's ``control``). With ``--faults``, each
fault of ``benchmark/faults.py`` for the cell's kind is planted in the
program and the run's numbers are read again (a training cell's numbers
are held against them too). One JSON line a seed. The benchmark's own
runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark import core
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", Path(__file__).with_name("run.py"))
    runmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runmod)
    cell = core.Cell(core.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        result, _, run = runmod.run_cell(cell, int(s), 0.0, False,
                                         torch.device("cuda"), t0)
        row = {"workload": args.workload, "seed": int(s),
               "program": {k: v["value"] for k, v in result["checks"].items()},
               "control": run.traffic.control(run),
               "faults": {},
               "card": result.get("card"), "seconds": time.perf_counter() - t0}
        del run
        torch.cuda.empty_cache()
        if args.faults:
            from benchmark import faults
            table = (faults.TRAINING if cell.mix["kind"] == "train_step"
                     else faults.SERVING)
            for name, plant in table.items():
                with plant():
                    res, _, run = runmod.run_cell(cell, int(s), 0.0, False,
                                                  torch.device("cuda"),
                                                  time.perf_counter())
                row["faults"][name] = {k: v["value"] for k, v in
                                       res["checks"].items()}
                del run
                torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
