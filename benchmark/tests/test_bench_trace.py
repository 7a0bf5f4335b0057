"""The device's busy time as a union of kernel intervals, and the idle
gaps attributed to the host operation open across each, on a synthetic
timeline."""

from types import SimpleNamespace

import torch

from benchmark import core

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def test_union_of_overlapping_kernels():
    # [0, 10) and [5, 12) overlap; [20, 25) stands alone; [21, 22) nested
    assert core.busy_seconds([(0, 10), (5, 12), (20, 25), (21, 22)]) == \
        (12 + 5) / 1e6
    assert core.busy_seconds([]) == 0


def test_read_profile_window_gaps_and_hosts():
    events = [
        _ev(core.MARK, 0, 100, CPU),
        _ev("aten::linear", 0, 40, CPU),
        _ev("cudaLaunchKernel", 10, 30, CPU),          # skipped: a launch
        _ev("aten::sync", 60, 100, CPU),
        _ev("gemm_a", 5, 20), _ev("gemm_b", 15, 25),     # overlap: 5..25
        _ev("Memcpy HtoD", 50, 55),
        _ev("attn_kernel_tc", 70, 90),
    ]
    prof = SimpleNamespace(events=lambda: events)
    t = core.read_profile(torch, prof)
    assert t["window_s"] == 100 / 1e6
    assert abs(t["busy_s"] - (20 + 5 + 20) / 1e6) < 1e-12
    idle = t["idle_by_host"]
    # gaps [0,5) and [25,50) (midpoint 37.5) under aten::linear, [55,70)
    # and [90,100) under aten::sync
    assert abs(idle["aten::linear"] - 30 / 1e6) < 1e-12
    assert abs(idle["aten::sync"] - 25 / 1e6) < 1e-12
    assert abs(sum(idle.values()) - (100 - 45) / 1e6) < 1e-12
    assert [o[0] for o in core.kernel_ops(t)] == ["gemm_a", "gemm_b",
                                                  "attn_kernel_tc"]
    bd = core.breakdown(t)
    assert bd["device_ops"][0][0] in ("attn_kernel_tc",)
    assert len(bd["idle_gaps"]) <= 10


def test_roofline_reader_returns_nothing_without_its_kernels():
    from benchmark.metrics import attention_roofline, device_idle_share
    run = SimpleNamespace(trace={"ops": [("gemm", 0, 10)], "busy_s": 1e-5,
                                 "window_s": 2e-5}, trace_requests=1)
    assert attention_roofline.read(run) is None
    assert device_idle_share.read(run) == 50.0
