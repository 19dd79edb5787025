"""The benchmark's per-layer readers that came with the mono cell
(``benchmark/metrics/``): ``map_depth_ray_share`` and
``loop_edges_per_call``, on the program's tracer with counters set by
hand.  Each reads None where nothing ran, and where the program does not
count what it reads."""
import os
import sys

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)        # harness


@pytest.fixture
def tracer_on():
    """The program's tracer on and empty for the test, off after it."""
    from goslam_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def _read(name, counts):
    """Install reader `name` (it clears the tracer), add `counts` as the
    program would, and read."""
    from harness import cells
    from harness.record import Recorder
    from goslam_tpu_torch.utils import trace
    rec = Recorder("cpu")
    r = cells.reader(name)
    r.install(rec)
    try:
        for k, n in counts.items():
            trace.add(k, n)
        return r.read(rec)
    finally:
        rec.restore()


@pytest.mark.parametrize("name, counts, want", [
    ("map_depth_ray_share",
     {"mapper.rays": 400, "mapper.rays_depth": torch.tensor(300)}, 75.0),
    ("map_depth_ray_share",
     {"mapper.rays": 400, "mapper.rays_depth": torch.tensor(0)}, 0.0),
    ("loop_edges_per_call",
     {"loop_closing.calls": 4, "loop_closing.edges": 1000}, 250.0),
])
def test_a_reader_divides_its_counters(tracer_on, name, counts, want):
    assert _read(name, counts) == pytest.approx(want)


@pytest.mark.parametrize("name, counts", [
    ("map_depth_ray_share", {}),
    # a program that counts rays but not those with depth (the parent)
    ("map_depth_ray_share", {"mapper.rays": 400}),
    ("map_depth_ray_share", {"mapper.rays_depth": torch.tensor(5)}),
    ("loop_edges_per_call", {}),
    ("loop_edges_per_call", {"loop_closing.edges": 10}),
])
def test_a_reader_reads_nothing_where_nothing_ran(tracer_on, name, counts):
    assert _read(name, counts) is None


def test_the_readers_are_declared_for_their_cells():
    from harness import cells
    bench = cells.load_benchmark()
    want = {"map_depth_ray_share": {"replica-mono.scan",
                                    "replica-rgbd.scan"},
            "loop_edges_per_call": {"replica-mono.scan", "replica-rgbd.scan",
                                    "euroc-stereo.fast"}}
    for w in {c["name"] for c in bench["workloads"]}:
        have = {m["name"] for m in cells.find(bench, w)["per_layer"]}
        for name, cells_of in want.items():
            assert (name in have) == (w in cells_of), (name, w)
