"""The reduction of a profile to busy time, device operations and named
idle gaps, on a stand-in for the profiler's raw events."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from harness.record import summarize


class _Event:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._n, self._d, self._s, self._t, self._a = (name, dev, start,
                                                       dur, annotation)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_time_is_the_union_of_device_work_without_annotations():
    CPU, GPU = DeviceType.CPU, DeviceType.CUDA
    ms = 1_000_000
    events = [
        _Event("track", CPU, 0, 100 * ms, annotation=True),
        _Event("frontend", CPU, 20 * ms, 50 * ms, annotation=True),
        # the profiler's mirror of a range on the device: no work
        _Event("track", GPU, 0, 100 * ms, annotation=True),
        _Event("frontend", GPU, 20 * ms, 50 * ms, annotation=True),
        _Event("conv", GPU, 0, 10 * ms),
        _Event("conv", GPU, 5 * ms, 10 * ms),         # overlaps the first
        _Event("gemm", GPU, 40 * ms, 20 * ms),
        _Event("aten::add", CPU, 0, 1 * ms),
    ]
    p = summarize(_prof(events), 0.1)
    assert p["busy_s"] == pytest.approx(0.035)
    assert p["kernel_s"] == pytest.approx({"conv": 0.02, "gemm": 0.02})
    assert {n for n, _ in p["device_ops"]} == {"conv", "gemm"}
    # the gap 15-40 ms lies in "frontend" (20-70) at its middle, the
    # innermost range there
    assert p["idle_gaps"] == [["frontend", pytest.approx(0.025)]]
