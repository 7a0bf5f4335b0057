"""A tiny serving cell for runs on the CPU: the configuration's structure
at small widths, written with its mix and limits into a directory laid
out as ``benchmark/``, and a ``BENCHMARK.json`` that names it."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import core

BENCH = core.BENCH


def tiny_config(name: str = "ditto-base") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    p = cfg["pipeline"]
    p["dit"].update(hidden_dim=64, text_dim=64, time_dim=32,
                    num_layers=2, num_heads=1 if p["dit"]["num_heads"] == 1
                    else 4)
    p["nac"].update(hidden_size=64, codebook_size=64)
    p["codec"].update(num_filters=4, dimension=16, codebook_size=64)
    p["vocoder"].update(upsample_initial_channel=192)
    p["sampler"]["num_steps"] = 4
    cfg["gpt2"]["vocab_size"] = 500
    return cfg


def write_cell(tmp: Path, *, config: dict = None, mix: dict = None,
               limits: dict = None, name: str = "tiny-serve") -> Path:
    """A directory with ``configs``, ``traffic/mixes``, ``limits`` and a
    ``BENCHMARK.json`` of one cell; returns the directory."""
    config = config or tiny_config()
    mix = mix or {"kind": "serve_closed", "batch": 2, "prompt_seconds": 0.25,
                  "text_tokens": 8, "pool": 2, "check_requests": 1,
                  "trace_requests": 1}
    limits = limits or {"stages_vs_served": 0.0, "refined_rel": 1e-4,
                        "vq_excess": 0.0, "codec_rel": 1e-4, "mel_rel": 1e-4,
                        "wave_rel": 1e-4}
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": name, "config": "tiny",
                           "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name]
    for sub in ("configs", "traffic/mixes", "limits"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(config))
    (tmp / "traffic" / "mixes" / "tiny-mix.json").write_text(json.dumps(mix))
    (tmp / "limits" / f"{name}.json").write_text(json.dumps(limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cell(tmp: Path, name: str = "tiny-serve", **kw):
    write_cell(tmp, name=name, **kw)
    return core.Cell(core.load_benchmark(tmp), name, bench_dir=tmp)
