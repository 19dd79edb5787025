"""The per-layer metric ``lowmem_slots_per_step`` (``metrics/
lowmem_slots_per_step.py``): the program's counters
``update_lowmem.slots / update_lowmem.steps``, declared for the cells
that run the backend's low-memory step; a program that counts no slots,
or has no tracer, reads as nothing and raises nothing."""
from __future__ import annotations

import sys

import pytest

from harness import cells, program
from harness.record import Recorder

NAME = "lowmem_slots_per_step"


@pytest.fixture
def tracer_on():
    """The program's tracer on and empty for the test, off after it."""
    from goslam_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def test_declared_for_the_cells_that_run_the_backend():
    bench = cells.load_benchmark()
    for w in ("replica-rgbd.scan", "euroc-stereo.fast", "replica-mono.scan"):
        entry = {m["name"]: m for m in cells.find(bench, w)["per_layer"]}
        assert entry[NAME]["moves"] == "fps"
        assert entry[NAME]["layer"] == "backend"
        assert entry[NAME]["source"] == "program_counter"
        assert entry[NAME]["better"] == "lower"
        assert entry[NAME]["unit"] == "slots"
    hover = cells.find(bench, "replica-rgbd.hover")["per_layer"]
    assert NAME not in {m["name"] for m in hover}


@pytest.mark.parametrize("steps, slots, per_step", [
    (2, 2 * 64, 64.0), (6, 2 * 96 + 4 * 128, 704 / 6), (4, 4 * 256, 256.0)])
def test_reads_slots_over_steps(tracer_on, steps, slots, per_step):
    trace = tracer_on
    rec = Recorder("cpu")
    r = cells.reader(NAME)
    r.install(rec)                  # clears the tracer for the window
    trace.add("update_lowmem.steps", steps)
    trace.add("update_lowmem.slots", slots)
    assert r.read(rec) == pytest.approx(per_step)
    rec.restore()


def test_the_programs_lowmem_step_counts_its_bucket(tracer_on):
    """The counter as the program's FactorGraph.update_lowmem adds it: one
    bucket of the live edges at each of a call's steps, read back as
    slots per step."""
    from goslam_tpu_torch.utils.shapes import bucket
    r = cells.reader(NAME)
    for live, steps in ((56, 2), (106, 2), (300, 2)):
        tracer_on.add("update_lowmem.calls")
        tracer_on.add("update_lowmem.steps", steps)
        tracer_on.add("update_lowmem.slots", bucket(live) * steps)
    assert r.read(Recorder("cpu")) == pytest.approx((64 + 128 + 384) / 3)


def test_a_program_that_counts_no_slots_reads_nothing(tracer_on):
    """The parent of the bucketed low-memory step counts calls, edges and
    steps, and never slots: the metric is left out, not read as 0."""
    tracer_on.add("update_lowmem.calls", 3)
    tracer_on.add("update_lowmem.edges", 180)
    tracer_on.add("update_lowmem.steps", 6)
    r = cells.reader(NAME)
    assert r.read(Recorder("cpu")) is None


def test_no_lowmem_step_reads_nothing(tracer_on):
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
