"""BENCHMARK.json against the benchmark's contract, every cell resolving
to its files by name, the result line's schema, and a new cell, traffic
mix and metric family added as files alone."""

import json
import math
import re
import time

import pytest
import torch

from benchmark import core
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = core.load_benchmark()


def _run_mod():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", core.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_metric_entries():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        # every listed cell reports the metric this one moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = core.Cell(BENCH, w["name"])
        traffic = cell.traffic()
        for fn in ("setup", "window", "traced", "check", "work", "control"):
            assert callable(getattr(traffic, fn))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(core.reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits, w["name"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and \
            (core.ROOT / c["file"]).exists()
        data = json.loads((core.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []


def test_result_line_schema_and_a_new_cell_from_files(tmp_path):
    """A cell, mix, configuration and limits written into a fresh
    directory run through the unchanged harness, and the line it prints
    has the contract's keys, the checks last."""
    cell = tiny.cell(tmp_path, name="throwaway-cell")
    torch.manual_seed(0)
    run_mod = _run_mod()
    result, lines, _ = run_mod.run_cell(cell, 2**31 + 77, 0.0, False,
                                        torch.device("cpu"),
                                        time.perf_counter())
    assert list(result)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in result
    assert result["attempted"] >= 1 and result["failed"] == 0
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert "setup_s" in result["metrics"]
    assert set(result["checks"]) == set(cell.limits)
    assert all(line.startswith("check ") for line in lines)
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(tmp_path):
    cell = tiny.cell(tmp_path)
    run_mod = _run_mod()
    result, _, _ = run_mod.run_cell(cell, 5, 0.0, True, torch.device("cpu"),
                                    time.perf_counter())
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert "sampler_s.serve" in result["metrics"]
    assert "mfu.serve" in result["metrics"]


def test_no_card_no_result(monkeypatch, capsys):
    """Without CUDA the command exits non-zero and prints no result."""
    run_mod = _run_mod()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", BENCH["workloads"][0]["name"],
                       "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_subseeds_are_stable_and_large_seeds_work(seed):
    a, b = core.subseed(seed, "weights"), core.subseed(seed, "weights")
    assert a == b and 0 <= a < 2**63
    assert core.subseed(seed, "noise0") != core.subseed(seed, "noise1")
    torch.Generator().manual_seed(a)


def test_a_new_traffic_kind_and_metric_family_are_found_by_name(
        tmp_path, monkeypatch):
    """A traffic kind and a metric family are modules found by name: a new
    one is a new file (here a module put in place of one) and an entry."""
    import sys
    import types
    kind = types.ModuleType("benchmark.traffic.throwaway_kind")

    def setup(run):
        run.tree = None

    def window(run, seconds):
        run.window = {"requests": 3, "wall_s": 1.5, "audio_s": 30.0}

    def check(run, checks):
        checks.add("always", 0.0)

    kind.setup, kind.window, kind.check = setup, window, check
    family = types.ModuleType("benchmark.metrics.throwaway_family")
    family.read = lambda run: run.window["requests"] / run.window["wall_s"]
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    monkeypatch.setitem(sys.modules, family.__name__, family)
    bench = tiny.write_cell(
        tmp_path, mix={"kind": "throwaway_kind"}, limits={"always": 0.0},
        name="throwaway")
    data = json.loads((bench / "BENCHMARK.json").read_text())
    data["end_to_end"].append({"name": "throwaway_family.rate",
                               "unit": "req/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["throwaway"]})
    (bench / "BENCHMARK.json").write_text(json.dumps(data))
    cell = core.Cell(core.load_benchmark(bench), "throwaway", bench_dir=bench)
    result, _, _ = _run_mod().run_cell(cell, 1, 0.0, False,
                                       torch.device("cpu"),
                                       time.perf_counter())
    assert result["metrics"]["throwaway_family.rate"]["value"] == 2.0
    assert result["correct"]
