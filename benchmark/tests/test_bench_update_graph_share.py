"""The per-layer metric ``update_graph_share`` (``metrics/
update_graph_share.py``): the program's counters ``update.replays /
update.calls`` as a share, declared for the cells that run the frontend's
update step; a program that counts no replays, or has no tracer, reads
as nothing and raises nothing."""
from __future__ import annotations

import sys

import pytest

from harness import cells, program
from harness.record import Recorder

NAME = "update_graph_share"


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
    for w in ("replica-rgbd.scan", "euroc-stereo.fast"):
        entry = {m["name"]: m for m in cells.find(bench, w)["per_layer"]}
        assert entry[NAME]["moves"] == "fps"
        assert entry[NAME]["layer"] == "frontend"
    hover = cells.find(bench, "replica-rgbd.hover")["per_layer"]
    assert NAME not in {m["name"] for m in hover}


@pytest.mark.parametrize("calls, replays, share", [
    (8, 6, 75.0), (5, 0, 0.0), (4, 4, 100.0)])
def test_reads_replays_over_calls(tracer_on, calls, replays, share):
    trace = tracer_on
    rec = Recorder("cpu")
    r = cells.reader(NAME)
    r.install(rec)                  # clears the tracer for the window
    trace.add("update.calls", calls)
    trace.add("update.replays", replays)
    assert r.read(rec) == pytest.approx(share)
    rec.restore()


def test_a_program_that_counts_no_replays_reads_nothing(tracer_on):
    """The parent of the update step's CUDA graphs counts calls and never
    replays: the metric is left out, not read as 0."""
    tracer_on.add("update.calls", 7)
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
