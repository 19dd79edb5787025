"""The per-layer metric ``slots_per_update`` (``metrics/
slots_per_update.py``): the program's counters ``update.slots /
update.calls``, declared for the cells that run the frontend's update
step; a program that counts no slots, or has no tracer, reads as nothing
and raises nothing."""
from __future__ import annotations

import sys

import pytest

from harness import cells, program
from harness.record import Recorder

NAME = "slots_per_update"


@pytest.fixture
def tracer_on():
    """The program's tracer on and empty for the test, off after it."""
    from goslam_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def test_declared_for_the_cells_that_run_the_update_step():
    bench = cells.load_benchmark()
    for w in ("replica-rgbd.scan", "euroc-stereo.fast", "replica-mono.scan"):
        entry = {m["name"]: m for m in cells.find(bench, w)["per_layer"]}
        assert entry[NAME]["moves"] == "fps"
        assert entry[NAME]["layer"] == "frontend"
        assert entry[NAME]["source"] == "program_counter"
        assert entry[NAME]["better"] == "lower"
    hover = cells.find(bench, "replica-rgbd.hover")["per_layer"]
    assert NAME not in {m["name"] for m in hover}


@pytest.mark.parametrize("calls, slots, per_call", [
    (8, 8 * 32, 32.0), (3, 24 + 48 + 48, 40.0), (4, 4 * 192, 192.0)])
def test_reads_slots_over_calls(tracer_on, calls, slots, per_call):
    trace = tracer_on
    rec = Recorder("cpu")
    r = cells.reader(NAME)
    r.install(rec)                  # clears the tracer for the window
    trace.add("update.calls", calls)
    trace.add("update.slots", slots)
    assert r.read(rec) == pytest.approx(per_call)
    rec.restore()


def test_the_programs_update_step_counts_its_bucket(tracer_on):
    """The counter as the program's FactorGraph.update adds it: one
    bucket a call, read back as slots per call."""
    from goslam_tpu_torch.utils.shapes import bucket
    r = cells.reader(NAME)
    live = (18, 33, 40)
    for n in live:
        tracer_on.add("update.calls")
        tracer_on.add("update.slots", bucket(n))
    assert r.read(Recorder("cpu")) == pytest.approx((24 + 48 + 48) / 3)


def test_a_program_that_counts_no_slots_reads_nothing(tracer_on):
    """The parent of the bucketed update step counts calls and never
    slots: the metric is left out, not read as 0."""
    tracer_on.add("update.calls", 7)
    tracer_on.add("update.replays", 6)
    r = cells.reader(NAME)
    assert r.read(Recorder("cpu")) is None


def test_no_update_step_reads_nothing(tracer_on):
    r = cells.reader(NAME)
    assert r.read(Recorder("cpu")) is None


def test_without_the_tracer_reads_nothing(monkeypatch):
    import goslam_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "goslam_tpu_torch.utils.trace", None)
    assert program.tracer() is None
    rec = Recorder("cpu")
    r = cells.reader(NAME)
    r.install(rec)
    assert r.read(rec) is None
    rec.restore()
