"""The program's spans as the benchmark reads them (``metrics/_spans.py``):
on a synthetic Kineto-like timeline, each device operation goes to the
innermost span whose profiler range holds its launch call, whatever the
spans' own clock reads, and a span's idle share is the part of its device
interval that none of its operations cover; on the CPU, a traced run of a
tiny cell reports the host metrics, leaves the device ones out, and leaves
what the other readers read as it was; a program without spans reports
none of them."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.metrics import (_spans, backward_host_ms, sampler_idle_share,
                               step_host_ms, step_launches,
                               vocoder_idle_share)
from benchmark.tests import tiny
from benchmark.tests.test_bench_schema import _run_mod

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
T0 = 1_700_000_000_000_000_000
NAMES = {"request", "sampler", "sampler.step", "vocoder"}


class _Ev:
    """A ``_KinetoEvent``'s accessors over fixed values (without
    ``is_user_annotation`` where ``annotation`` is None, as some builds
    have it)."""

    def __init__(self, name, start, end, dev=CPU, corr=0, linked=0,
                 annotation=False):
        self._v = dict(name=name, start_ns=start, end_ns=end, device_type=dev,
                       correlation_id=corr, linked_correlation_id=linked)
        if annotation is not None:
            self._v["is_user_annotation"] = annotation

    def __getattr__(self, key):
        v = self.__dict__["_v"]
        if key in v:
            return lambda: v[key]
        raise AttributeError(key)


def _span(name, start, end, parent, request=0):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "request": request, "attrs": {}}


# the profiler's ranges: request [0, 1000): sampler [100, 600) over two
# steps [100, 300) and [300, 600); vocoder [700, 950)
RANGES = [("request", 0, 1000), ("sampler", 100, 600),
          ("sampler.step", 100, 300), ("sampler.step", 300, 600),
          ("vocoder", 700, 950)]
PARENTS = [None, 0, 1, 1, 0]
# the spans' own readings of the same stretches, 80 ns late: attribution
# follows the ranges
SPANS = [_span(n, s + 80, e + 80, p) for (n, s, e), p in zip(RANGES, PARENTS)]


def _kernel(name, corr, start, end, linked=0, annotation=None):
    return _Ev(name, start, end, CUDA, corr, linked, annotation)


def _launch(corr, at, name="cudaLaunchKernel"):
    return _Ev(name, at, at + 5, CPU, corr)


def _timeline(shift=0):
    """Launches at host times 50 (request), 150 and 160 (step 0), 350
    (step 1), 650 (request, between stages), 720 and 800 (vocoder), 1200
    (outside every span); device times well after them."""
    events = [_Ev(n, s, e, annotation=True) for n, s, e in RANGES] + [
        # a host op whose own correlation id is a kernel's: not a launch
        _Ev("aten::mm", 140, 170, corr=4),
        _launch(1, 50), _launch(2, 150), _launch(3, 160),
        _launch(4, 350, "cuLaunchKernel"), _launch(5, 650), _launch(6, 720),
        _launch(7, 800, "cudaMemcpyAsync"), _launch(8, 1200),
        _kernel("pre", 1, 2000, 2010),
        _kernel("gemm", 2, 2100, 2200, linked=9),
        _kernel("add", 3, 2150, 2250),
        _kernel("attn", 4, 2300, 2350),
        _kernel("glue", 5, 2400, 2410),
        _kernel("conv", 6, 2500, 2600),
        _kernel("Memcpy DtoD", 7, 2700, 2720),
        _kernel("late", 8, 3000, 3010),
        # a range drawn on the device's timeline, with and without the
        # annotation flag: not an operation
        _kernel("sampler", 0, 2100, 2350),
        _kernel("sampler", 0, 2100, 2350, annotation=True),
    ]
    for e in events:
        e._v["start_ns"] += shift
        e._v["end_ns"] += shift
    return events


def _results(events, t0):
    return SimpleNamespace(events=lambda: events, trace_start_ns=lambda: t0)


def _shifted(spans, by):
    return [dict(s, start_ns=s["start_ns"] + by, end_ns=s["end_ns"] + by)
            for s in spans]


@pytest.mark.parametrize("relative", [False, True],
                         ids=["epoch_ns", "from_trace_start"])
def test_each_operation_goes_to_the_innermost_range_of_its_launch(relative):
    # some builds stamp events from the trace's start: both read the same
    events = _timeline(0 if relative else T0)
    launches, ops, ranges = _spans.read_kineto(torch, _results(events, T0),
                                               NAMES)
    assert launches[2] == T0 + 150 and len(launches) == 8
    assert [o[0] for o in ops] == ["pre", "gemm", "add", "attn", "glue",
                                   "conv", "Memcpy DtoD", "late"]
    assert ranges == [(n, s + T0, e + T0) for n, s, e in RANGES]
    timed = _spans.on_ranges(_shifted(SPANS, T0), ranges)
    assert [(t["start_ns"] - T0, t["end_ns"] - T0) for t in timed] == \
        [(s, e) for _, s, e in RANGES]
    assert [t["parent"] for t in timed] == PARENTS
    got = {k: [o[0] for o in v]
           for k, v in _spans.attribute(timed, launches, ops).items()}
    assert got == {0: ["pre", "glue"], 2: ["gemm", "add"], 3: ["attn"],
                   4: ["conv", "Memcpy DtoD"], None: ["late"]}


def test_spans_and_ranges_that_do_not_pair_up_give_nothing():
    assert _spans.on_ranges(SPANS, RANGES[:-1]) is None
    assert _spans.on_ranges(SPANS[:-1], RANGES) is None
    assert _spans.on_ranges(SPANS, RANGES) is not None


def test_an_operation_whose_launch_was_not_traced_goes_to_no_span():
    got = _spans.attribute(SPANS, {}, [("k", 10, 20, 3)])
    assert got == {None: [("k", 10, 20)]}


def _run_with(events):
    launches, ops, ranges = _spans.read_kineto(torch, _results(events, 0),
                                               NAMES)
    timed = _spans.on_ranges(SPANS, ranges)
    host = SPANS + [_span("sampler.step", 1000, 1400, 1)]
    return SimpleNamespace(program_spans={
        "host": host, "spans": timed,
        "ops": _spans.attribute(timed, launches, ops)})


def test_idle_shares_launches_and_host_durations():
    run = _run_with(_timeline())
    # the sampler's ops: gemm [2100, 2200), add [2150, 2250), attn
    # [2300, 2350): interval 250, covered 200
    assert sampler_idle_share.read(run) == pytest.approx(100 * 50 / 250)
    # conv [2500, 2600) and the copy [2700, 2720): interval 220, covered 120
    assert vocoder_idle_share.read(run) == pytest.approx(100 * 100 / 220)
    assert step_launches.read(run) == pytest.approx(3 / 2)
    # steps of 200, 300 and 400 ns
    assert step_host_ms.read(run) == pytest.approx(300 / 1e6)
    assert backward_host_ms.read(run) is None


def test_device_readers_return_nothing_without_device_operations():
    run = _run_with([e for e in _timeline() if e.device_type() != CUDA])
    assert sampler_idle_share.read(run) is None
    assert step_launches.read(run) is None
    assert step_host_ms.read(run) is not None
    assert step_host_ms.read(SimpleNamespace(program_spans=None)) is None


TRAIN_MIX = {"kind": "train_step", "batch": 2, "audio_seconds": 0.25,
             "text_ids": 32, "pool": 4, "check_steps": 1, "trace_steps": 2}
TRAIN_LIMITS = {"loss_rel": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
SERVE_ONLY = ("step_launches.single", "sampler_idle_share.serve",
              "vocoder_idle_share.serve", "backward_idle_share.train")


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_traced_run_reads_the_programs_spans_on_the_cpu(tmp_path,
                                                        monkeypatch, kind):
    """The helper runs after the traced phase; the host metrics come out,
    the device ones are left out on the CPU, and the traced phase's
    outputs and the launch counters are what they were."""
    from ditto_tts_tpu_torch import kernels
    if kind == "serve":
        cell = tiny.cell(tmp_path)
        host, unit, n = "step_host_ms.serve", "sampler.step", \
            cell.mix["trace_requests"]
        per = cell.config["pipeline"]["sampler"]["num_steps"]
    else:
        cell = tiny.cell(tmp_path, mix=TRAIN_MIX, limits=TRAIN_LIMITS,
                         name="tiny-train")
        host, unit, n, per = "backward_host_ms.train", "train.backward", \
            TRAIN_MIX["trace_steps"], 1
    monkeypatch.setitem(kernels.launches, "attention", 7)
    result, _, run = _run_mod().run_cell(cell, 2**31 + 9, 0.0, True,
                                         torch.device("cpu"),
                                         time.perf_counter())
    assert kernels.launches["attention"] == 7
    m = result["metrics"]
    assert m[host]["value"] > 0 and m[host]["unit"] == "ms"
    assert not set(SERVE_ONLY) & set(m)
    for phase in ("host", "spans"):
        names = [s["name"] for s in run.program_spans[phase]]
        assert names.count(unit) == n * per
    # each span of (b) took its profiler range's extent
    assert len(run.program_spans["offset_ns"]) == len(names)
    assert run.window["requests"] == n
    if kind == "serve":
        assert "backward_host_ms.train" not in m
        assert result["checks"]["stages_vs_served"]["value"] == 0.0
        assert len(run.outputs) == n
    else:
        assert "step_host_ms.serve" not in m
        assert run.steps_done == TRAIN_MIX["check_steps"] + 4 * n


def test_a_program_without_spans_reports_none_of_them(tmp_path, monkeypatch):
    from ditto_tts_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recording")
    cell = tiny.cell(tmp_path)
    result, _, run = _run_mod().run_cell(cell, 3, 0.0, True,
                                         torch.device("cpu"),
                                         time.perf_counter())
    assert run.program_spans is None
    assert not any(k.split(".")[0] in ("step_host_ms", "step_launches")
                   for k in result["metrics"])
    assert "sampler_s.serve" in result["metrics"]
