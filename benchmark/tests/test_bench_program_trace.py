"""The per-layer metrics read from the program's own tracer
(``harness/program.py``): a traced run of a cell at a tiny size on the
CPU reads every one of them; a program without the tracer reads as
nothing and raises nothing; on the card, the tracer's spans and the
profiler's ranges share one clock."""
from __future__ import annotations

import statistics
import sys

import pytest
import torch

import run
from harness import cells, program
from harness.record import Recorder

PROGRAM_METRICS = ("layer_ms.ingest", "layer_ms.loop_closing",
                   "proposal_ms_per_frame", "edges_per_update",
                   "keyframe_share")
# 64x96 frames, every frame a keyframe and kept, loop closing once 6
# keyframes are past; set-up's system goes on into the window
TINY = {"cam": {"H_out": 64, "W_out": 96},
        "tracking": {"buffer": 32, "warmup": 4,
                     "motion_filter": {"thresh": -1.0},
                     "frontend": {"window": 6, "keyframe_thresh": 0.0}},
        "only_tracking": True}
SEED = 2 ** 31 + 91


@pytest.fixture(scope="module")
def traced():
    spec = cells.find(cells.load_benchmark(), "replica-rgbd.scan")
    spec["traffic"] = dict(spec["traffic"], replay=False, warmup_frames=8)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run.run_cell(spec, SEED, 3, True, device="cpu",
                            overrides=TINY)
    finally:
        torch.set_num_threads(n)


def test_the_program_metrics_are_declared_for_their_cells():
    bench = cells.load_benchmark()
    for w in ("replica-rgbd.scan", "euroc-stereo.fast",
              "replica-rgbd.hover"):
        names = {m["name"] for m in cells.find(bench, w)["per_layer"]}
        want = {"layer_ms.ingest", "keyframe_share"} if w.endswith(
            "hover") else set(PROGRAM_METRICS)
        assert want <= names, (w, names)


def test_a_traced_run_reads_every_program_metric(traced):
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    for name in PROGRAM_METRICS:
        assert name in m and m[name] > 0, (name, m)
    assert m["keyframe_share"] == pytest.approx(100.0)
    assert m["edges_per_update"] >= 2


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_without_the_tracer_a_reader_reads_nothing(name, monkeypatch):
    """A program that predates the tracer has none: installing and
    reading raise nothing, and the metric is left out."""
    import goslam_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "goslam_tpu_torch.utils.trace", None)
    assert program.tracer() is None
    rec = Recorder("cpu")
    r = cells.reader(name)
    r.install(rec)
    assert r.read(rec) is None
    rec.restore()


def test_install_turns_the_tracer_on_for_the_window_only():
    from goslam_tpu_torch.utils import trace
    rec = Recorder("cpu")
    program.install(rec)
    program.install(rec)            # a second reader shares the hook
    assert trace.ON
    with trace.span("slam.track"):
        trace.add("frames")
    rec.restore()
    assert not trace.ON
    assert program.counter("frames") == 1
    assert len(program.durations_s("slam.track")) == 1


@pytest.mark.card
def test_spans_and_profiler_ranges_share_a_clock_on_the_card(card):
    """Spans around device work in a CUDA profile: each is a range of its
    name that starts within 50 us of the span (the tracer's offset
    applied) and lies inside it."""
    from goslam_tpu_torch.utils import trace
    x = torch.randn(256, 256, device=card)
    trace.reset()
    trace.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                with trace.span("slam.track"):
                    with trace.span("slam.encode"):
                        y = x @ x
                    float(y[0, 0])
    finally:
        trace.disable()
    off = trace.clock_offset_ns()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("slam.") and e.is_user_annotation() \
                and e.device_type() != torch.autograd.DeviceType.CUDA:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    seen, lags = {}, []
    for r in trace.records():
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        s, t = sorted(ranges[r.name])[k]
        assert r.start_ns + off - 5_000 <= s and t <= r.end_ns + off + 5_000
        lags.append(s - (r.start_ns + off))
    lags.sort()
    print(f"clock check: {len(lags)} spans, range start after span start "
          f"median {statistics.median(lags) / 1e3:.2f} us, 99th "
          f"{lags[int(0.99 * len(lags))] / 1e3:.2f} us, max "
          f"{lags[-1] / 1e3:.2f} us")
    assert statistics.median(lags) < 50_000
    assert lags[int(0.99 * len(lags))] < 50_000
