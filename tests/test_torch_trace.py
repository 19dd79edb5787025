"""The port's tracer (``goslam_tpu_torch/utils/trace.py``) on a tiny CPU
system: the synthetic room at 64x96, RGB-D, 7 frames, every frame
admitted, loop closing, global BA every 2 keyframes and a mapping round
every 2, so every layer span is reached.  The system runs twice: with
tracing off, and with it on inside a CPU ``torch.profiler`` run."""
import json
import os
import statistics
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")
FRAMES = 7

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

LAYER_SPANS = {
    "slam.build": None, "slam.build_net": "slam.build",
    "slam.build_video": "slam.build", "slam.build_tracker": "slam.build",
    "slam.build_mapper": "slam.build",
    "slam.track": None, "slam.ingest": "slam.track",
    "slam.motion_filter": "slam.track", "slam.encode": "slam.motion_filter",
    "slam.flow": "slam.motion_filter", "slam.admit": "slam.motion_filter",
    "slam.frontend": "slam.track", "slam.initialize": "slam.frontend",
    "slam.update": ("slam.frontend", "slam.initialize"),
    "slam.keyframe_test": "slam.frontend",
    "slam.loop_closing": "slam.frontend",
    "slam.update_lowmem": ("slam.loop_closing", "slam.global_ba"),
    "slam.propose": ("slam.frontend", "slam.initialize",
                     "slam.loop_closing", "slam.global_ba"),
    "slam.global_ba": "slam.track", "slam.multiview_filter": "slam.track",
    "slam.mapper": "slam.track", "slam.map_step": "slam.mapper",
}


def _cfg():
    from goslam_tpu_torch.config import default_config, update_recursive
    return update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd", "multichip": False,
        "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96, "H_edge": 0,
                "W_edge": 0},
        "data": {"input_folder": "", "n_frames": 14, "output": ""},
        "tracking": {"buffer": 16, "warmup": 4, "upsample": False,
                     "weight_calib": 4.0, "motion_filter": {"thresh": -1.0},
                     "multiview_filter": {"thresh": 0.25},
                     "frontend": {"window": 4, "max_factors": 24,
                                  "enable_loop": True,
                                  "keyframe_thresh": 4.0},
                     "global_ba_every": 2},
        "mapping": {"mapping_every": 2, "pixels": 256, "iters": 1,
                    "mapping_window_size": 6, "post_processing_iters": 1},
        "rendering": {"N_samples": 8, "N_surface": 8},
        "meshing": {"resolution": 32}})


def _drive(out_dir, traced):
    """Build a system and track FRAMES frames; returns the system and,
    traced, the profile.  Records each FactorGraph.update call's live
    edges, and the positive target depths of each map step's rays (its
    padding rays have depth 0)."""
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.mapping.mapper import Mapper
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    from goslam_tpu_torch.utils import trace

    cfg = _cfg()
    ds = Synthetic(cfg)
    sd = load_checkpoint(CKPT)
    live, update = [], FactorGraph.update
    depths, train_step = [], Mapper.train_step

    def counted(self, *a, **k):
        if self.valid.any():
            live.append(int(self.valid.sum()))
        return update(self, *a, **k)

    def step(self, rays_o, rays_d, gt_color, gt_depth, *a, **k):
        depths.append(int((gt_depth > 0).sum()))
        return train_step(self, rays_o, rays_d, gt_color, gt_depth, *a, **k)

    FactorGraph.update = counted
    Mapper.train_step = step
    prof = None
    try:
        trace.reset()
        if traced:
            trace.enable()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            prof.__enter__()
        slam = SLAMSystem(cfg, state_dict=sd, output=str(out_dir),
                          device="cpu")
        calls = 0
        for i in range(FRAMES):
            _, img, depth, intr, gt = ds[i]
            slam.track(float(i), img, depth, intr, gt)
            calls += 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        trace.disable()
        FactorGraph.update = update
        Mapper.train_step = train_step
    return {"slam": slam, "prof": prof, "live": live, "calls": calls,
            "depths": depths,
            "records": trace.records(), "counters": trace.counters(),
            "offset": trace.clock_offset_ns()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        off = _drive(tmp_path_factory.mktemp("off"), False)
        on = _drive(tmp_path_factory.mktemp("on"), True)
    finally:
        torch.set_num_threads(n)
    return {"off": off, "on": on}


def test_tracing_off_records_nothing(runs):
    off = runs["off"]
    assert off["records"] == []
    # the launch counters count on or off; the CPU launches no kernel
    assert off["counters"] == {}


def test_spans_nest_close_and_share_their_frame(runs):
    recs = runs["on"]["records"]
    names = Counter(r.name for r in recs)
    assert set(names) == set(LAYER_SPANS), names
    for i, r in enumerate(recs):
        assert r.end_ns >= r.start_ns > 0, r
        want = LAYER_SPANS[r.name]
        if want is None:
            assert r.parent == -1, r
            continue
        assert 0 <= r.parent < i, r
        p = recs[r.parent]
        assert p.name in ((want,) if isinstance(want, str) else want), \
            (r, p)
        # nested in time, and in the parent's frame
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)
        assert r.frame == p.frame, (r, p)
    tracks = [r for r in recs if r.name == "slam.track"]
    assert [r.frame for r in tracks] == list(range(1, FRAMES + 1))
    assert all(r.frame == 0 for r in recs if r.name.startswith("slam.build"))


def test_counters_agree_with_the_system(runs):
    on = runs["on"]
    c, slam = on["counters"], on["slam"]
    assert c["frames"] == on["calls"] == FRAMES
    assert c["keyframes"] - c.get("keyframes_removed", 0) \
        == slam.video.counter
    assert c.get("keyframes_removed", 0) > 0
    assert c["update.calls"] == len(on["live"])
    assert c["update.edges"] == sum(on["live"])
    names = Counter(r.name for r in on["records"])
    assert c["update.calls"] == names["slam.update"]
    assert c["update_lowmem.calls"] == names["slam.update_lowmem"]
    assert c["loop_closing.calls"] == names["slam.loop_closing"]
    assert c["global_ba.calls"] == names["slam.global_ba"]
    assert c["mapper.steps"] == names["slam.map_step"]
    assert c["mapper.rounds"] >= 1 and c["mapper.rays"] > 0
    assert c["update_lowmem.edges"] > 0
    assert not any(k.startswith("pcg.") for k in c)   # under 192 poses


def test_the_warm_up_is_one_span_inside_the_frontend(runs):
    """slam.initialize: once per system, inside slam.frontend, around the
    warm-up's 16 update steps and its two edge proposals."""
    recs = runs["on"]["records"]
    init = [i for i, r in enumerate(recs) if r.name == "slam.initialize"]
    assert len(init) == 1
    assert recs[recs[init[0]].parent].name == "slam.frontend"
    inside = Counter(r.name for r in recs if r.parent == init[0])
    assert inside == {"slam.update": 16, "slam.propose": 2}, inside


def test_rays_with_depth_are_counted_beside_the_rays(runs):
    """mapper.rays_depth: the rays of each map step whose target depth is
    positive, padding left out, summed on the device and read with the
    counters; at most mapper.rays."""
    on = runs["on"]
    c = on["counters"]
    assert len(on["depths"]) == c["mapper.steps"] > 0
    assert c["mapper.rays_depth"] == sum(on["depths"]) > 0
    assert c["mapper.rays_depth"] <= c["mapper.rays"]


def test_tracing_changes_no_result(runs):
    a, b = runs["off"]["slam"], runs["on"]["slam"]
    n = a.video.counter
    assert b.video.counter == n
    np.testing.assert_array_equal(a.video.poses[:n].numpy(),
                                  b.video.poses[:n].numpy())
    np.testing.assert_array_equal(a.video.disps[:n].numpy(),
                                  b.video.disps[:n].numpy())


def test_spans_are_profiler_ranges_on_one_clock(runs):
    """Each span is a profiler range of its name, read on the same clock
    (the tracer's offset applied): the range lies inside the span, and
    starts a few microseconds after it (the range's own opening)."""
    on = runs["on"]
    ranges = {}
    for e in on["prof"].profiler.kineto_results.events():
        if e.name().startswith("slam.") and e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    seen, lags = Counter(), []
    for r in on["records"]:
        k = seen[r.name]
        seen[r.name] += 1
        s, t = sorted(ranges[r.name])[k]
        start, end = r.start_ns + on["offset"], r.end_ns + on["offset"]
        # 5 us for the offset's own reading
        assert start - 5_000 <= s and t <= end + 5_000, (r, s, t)
        lags.append(s - start)
    assert {n: len(v) for n, v in ranges.items()} == dict(seen)
    assert statistics.median(lags) < 50_000, lags


def test_write_chrome_loads_back(runs, tmp_path):
    from goslam_tpu_torch.utils import trace
    path = tmp_path / "trace.json"
    trace.write_chrome(str(path))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    recs = runs["on"]["records"]
    assert [e["name"] for e in spans] == [r.name for r in recs]
    for e, r in zip(spans, recs):
        assert e["ts"] == r.start_ns / 1e3
        assert e["args"]["frame"] == r.frame
        assert e["args"]["parent"] == r.parent
    counters = {e["name"]: e["args"]["value"] for e in doc["traceEvents"]
                if e["ph"] == "C"}
    assert counters == runs["on"]["counters"] == doc["counters"]


def test_span_when_off_is_one_shared_null_context():
    from goslam_tpu_torch.utils import trace
    trace.disable()
    trace.reset()
    assert trace.span("slam.a") is trace.span("slam.b")
    with trace.span("slam.a"):
        trace.add("frames")
    trace.launch("edge_system")
    assert trace.counters() == {"launch.edge_system": 1}
    assert trace.records() == []
    trace.reset()
    assert trace.counters() == {} and trace.records() == []


def test_a_device_count_is_summed_on_the_device_and_read_as_an_int():
    from goslam_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        trace.add("mapper.rays_depth", torch.tensor(3))
        trace.add("mapper.rays_depth", torch.tensor([1, 0, 1]).sum())
        trace.add("mapper.rays", 6)
    finally:
        trace.disable()
    trace.add("mapper.rays_depth", torch.tensor(100))     # off: not counted
    c = trace.counters()
    assert c == {"mapper.rays_depth": 5, "mapper.rays": 6}
    assert type(c["mapper.rays_depth"]) is int
    trace.reset()
    assert trace.counters() == {}


def _pcg_counters():
    """The tracer's counters after a 3-step PCG BA over a chain of 8
    poses at 8x12."""
    from goslam_tpu_torch.ops import dba, lie, projective
    from goslam_tpu_torch.utils import trace
    g = torch.Generator().manual_seed(3)
    P, ht, wd = 8, 8, 12
    poses = [lie.identity()]
    for _ in range(P - 1):
        poses.append(lie.compose(lie.exp(0.03 * torch.randn(6, generator=g)),
                                 poses[-1]))
    poses = torch.stack(poses)
    disps = 0.6 + 0.15 * torch.rand((P, ht, wd), generator=g)
    intr = torch.tensor([6.0, 6.0, wd / 2 - 0.5, ht / 2 - 0.5])
    ii, jj = torch.meshgrid(torch.arange(P), torch.arange(P), indexing="ij")
    keep = (ii != jj) & ((ii - jj).abs() <= 2)
    ii, jj = ii[keep], jj[keep]
    coords, _ = projective.transform(poses, disps, intr, ii, jj)
    weight = torch.rand(coords.shape, generator=g)
    eta = torch.full((P, ht, wd), 1e-4)
    trace.reset()
    trace.enable()
    try:
        dba.ba(poses, disps, intr, torch.zeros_like(disps), coords + 0.3,
               weight, eta, ii, jj, torch.ones(len(ii), dtype=torch.bool),
               1, P, iters=3, max_deg=8, solver="cg", cg_iters=64)
    finally:
        trace.disable()
    return trace.counters()


def test_pcg_iterations_are_counted(monkeypatch):
    from goslam_tpu_torch.ops import dba
    real, seen = dba._pcg, []

    def spy(*a, **k):
        x, n = real(*a, **k)
        seen.append(n)
        return x, n

    monkeypatch.setattr(dba, "_pcg", spy)
    c = _pcg_counters()
    assert c["pcg.solves"] == len(seen) == 3
    assert c["pcg.iters"] == sum(seen) > 3
