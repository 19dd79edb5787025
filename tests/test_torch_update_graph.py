"""The frontend's update step (``FactorGraph.update``) as one function
that runs eagerly or as a CUDA-graph replay.

  * On the CPU (always eager): the window read and written at ``base +
    arange(P)`` by device index, and the slabs written in place, give the
    same result as the step written with host slices and rebound slabs,
    through archived, added and removed edges and a shift of the window's
    base; the slabs keep their storage; no step is captured or replayed.
  * The step's runner (``_StepGraphs``) with a stand-in for the capture:
    a step's kernel launches count once each time its work runs, eager
    or replayed, and never at the capture; off CUDA nothing is captured.
  * The trajectory filler's one graph for every batch gives the poses a
    fresh graph per batch gives.
  * The update operator runs over a bucket of slots that holds the live
    edges: the staged slot list holds each live slot once and pads with
    invalid slots, whose bytes the step keeps; ``update.slots`` counts
    the bucket; slot layouts of one bucket share one graph key, and a
    graph captured from one layout replays another exactly.
  * ``dba.ba`` with the caller's host degree raises the same error on an
    overflow as with the degree it reads from the device, and reads
    nothing then.
  * On the card (marker ``card``, skipped without one; this file imports
    no JAX, so run it there without the JAX conftest: ``python -m pytest
    --noconftest -m card tests/test_torch_update_graph.py``): at the
    ``replica-rgbd.scan`` cell's shapes, with every key captured from
    another slot layout, each step of a sequence is run eagerly and by
    replay from one saved state, and the two agree within rounding; an
    edit of one archived edge alone moves the replay as it moves the
    eager step; each replay counts its kernel launches.
"""
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")


def _cfg(ht, wd, frames, warmup, window, max_factors, compute_dtype=None):
    from goslam_tpu_torch.config import default_config, update_recursive
    return update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd", "multichip": False,
        "only_tracking": True,
        "cam": {"H": ht, "W": wd, "H_out": ht, "W_out": wd, "H_edge": 0,
                "W_edge": 0},
        "data": {"input_folder": "", "n_frames": frames, "output": ""},
        "tracking": {"buffer": 32, "warmup": warmup, "upsample": False,
                     "weight_calib": 4.0, "compute_dtype": compute_dtype,
                     "motion_filter": {"thresh": -1.0},
                     "frontend": {"window": window,
                                  "max_factors": max_factors,
                                  "enable_loop": False,
                                  "keyframe_thresh": 0.0},
                     "global_ba_every": 1000}})


def _tracked(cfg, n, device, out_dir):
    """A system that has tracked the first n synthetic frames (the
    frontend initialized)."""
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    ds = Synthetic(cfg)
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT),
                      output=str(out_dir), device=device)
    for i in range(n):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    assert slam.frontend.is_initialized
    return slam


def _slice_update(g, t0=None, t1=None, iters=2, use_inactive=False,
                  motion_only=False, lm=1e-4, ep=0.1):
    """The update step written with host slices of the window and slabs
    rebound by ``torch.where``, on copies: what ``FactorGraph.update``
    must give.  Returns the video's and the slabs' tensors after it."""
    from goslam_tpu_torch.models.droidnet import upsample_disp
    from goslam_tpu_torch.ops import corr, dba, projective
    from goslam_tpu_torch.tracking.factor_graph import (
        CG_ITERS, DEG_BUCKETS, EPS_DAMP)
    from goslam_tpu_torch.utils.shapes import bucket
    v = g.video
    poses, disps, damping, disps_up = (
        t.clone() for t in (v.poses, v.disps, v.damping, v.disps_up))
    vi, vj = g.ii[g.valid], g.jj[g.valid]
    if t0 is None:
        t0 = max(1, int(vi.min()) + 1)
    t0 = max(1, t0)
    if t1 is None:
        t1 = int(max(vi.max(), vj.max())) + 1
    inac_ok = (g.valid_inac & (g.ii_inac >= t0 - 3) & (g.jj_inac >= t0 - 3)
               if use_inactive else np.zeros(g.cap_inac, bool))
    lows = [vi.min(), vj.min(), t0 - 1]
    if inac_ok.any():
        lows += [g.ii_inac[inac_ok].min(), g.jj_inac[inac_ok].min()]
    base = int(min(lows))
    P = bucket(t1 - base)
    base = g._window_base(base, P)
    ii_all = np.concatenate([vi, g.ii_inac[inac_ok]])
    max_deg = bucket(int(np.bincount(ii_all).max()), DEG_BUCKETS)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=v.device)

    valid = dev(g.valid)
    ii_s, jj_s = dev(np.where(g.valid, g.ii, 0)), dev(np.where(g.valid,
                                                               g.jj, 0))
    coords1, _ = projective.transform(poses, disps, v.intrinsics, ii_s, jj_s)
    motion = g._motion_features(coords1, g.target)
    corr_feat = corr.lookup(g.pyramid, coords1)
    ii_local = (ii_s - base).clamp(0, P - 1)
    jj_local = (jj_s - base).clamp(0, P - 1)
    net_new, delta, w_new, eta, upmask, has_edge = g.model.update(
        g.net.to(g.cdt), v.inps[ii_s], corr_feat.to(g.cdt),
        motion.to(g.cdt), dtype=g.cdt, ii=ii_local, edge_valid=valid,
        num_frames=P)
    vm = valid[:, None, None, None]
    net = torch.where(vm, net_new.to(g.net.dtype), g.net)
    target = torch.where(vm, coords1 + delta.float(), g.target)
    weight = torch.where(vm, w_new.float() * g.model.weight_calib, g.weight)

    win = slice(base, base + P)
    damping_w = torch.where(has_edge[:, None, None], eta.float(),
                            damping[win])
    damping[win] = damping_w
    ii_ba = torch.cat([ii_local, (dev(g.ii_inac) - base).clamp(0, P - 1)])
    jj_ba = torch.cat([jj_local, (dev(g.jj_inac) - base).clamp(0, P - 1)])
    poses_w, disps_w = dba.ba(
        poses[win], disps[win], v.intrinsics, v.disps_sens[win],
        torch.cat([target, g.target_inac]), torch.cat([weight, g.weight_inac]),
        0.2 * damping_w + EPS_DAMP, ii_ba, jj_ba,
        torch.cat([valid, dev(inac_ok)]), t0 - base, t1 - base, iters=iters,
        lm=lm, ep=ep, motion_only=motion_only, max_deg=max_deg,
        cg_iters=CG_ITERS)
    poses[win] = poses_w
    disps[win] = disps_w
    if g.upsample:
        up = upsample_disp(disps_w, upmask.float())
        disps_up[win] = torch.where(has_edge[:, None, None], up,
                                    disps_up[win])
    return {"poses": poses, "disps": disps, "damping": damping,
            "disps_up": disps_up, "net": net, "target": target,
            "weight": weight}


def _after(g):
    v = g.video
    return {"poses": v.poses, "disps": v.disps, "damping": v.damping,
            "disps_up": v.disps_up, "net": g.net, "target": g.target,
            "weight": g.weight}


def _edits(g, lowest):
    """The host edits between the steps of a sequence, each followed by
    an update with these arguments: archive every edge below frame
    `lowest` (a shift of the window's base), add an edge, remove a live
    edge, and a motion-only step over an explicit window."""
    t = g.video.counter

    def archive(g):
        g.rm_factors(g.valid & ((g.ii < lowest) | (g.jj < lowest)),
                     store=True)

    def add(g):
        seen = set(zip(g.ii[g.valid].tolist(), g.jj[g.valid].tolist()))
        seen |= set(zip(g.ii_inac[g.valid_inac].tolist(),
                        g.jj_inac[g.valid_inac].tolist()))
        pair = next((i, j) for i in range(t - 1, -1, -1)
                    for j in range(t - 1, -1, -1)
                    if i != j and (i, j) not in seen)
        n = g.n_edges()
        g.add_factors([pair[0]], [pair[1]])
        assert g.n_edges() == n + 1

    def remove(g):
        mask = np.zeros(g.cap, bool)
        mask[np.flatnonzero(g.valid)[-1]] = True
        g.rm_factors(mask)

    return [(lambda g: None, {"use_inactive": True}),
            (archive, {"use_inactive": True}),
            (add, {"use_inactive": True}),
            (remove, {"t0": lowest + 1, "use_inactive": True}),
            (lambda g: None, {"t0": t - 2, "t1": t, "motion_only": True})]


@pytest.fixture(scope="module")
def cpu_slam(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _tracked(_cfg(64, 96, 24, 4, 4, 24), 7, "cpu",
                       tmp_path_factory.mktemp("cpu"))
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_graph(cpu_slam):
    return cpu_slam.frontend.graph


@pytest.mark.parametrize("lowest, upsample", [(0, True), (2, False),
                                              (3, True)])
def test_index_window_and_in_place_slabs_match_slices(cpu_graph, lowest,
                                                      upsample):
    """Each step of the sequence against the slice-based step from the
    same state: equal, through the base's shift (lowest 2 and 3 archive
    the edges below it, so the window starts higher); the slabs and the
    video keep their storage, and on the CPU nothing is captured."""
    from goslam_tpu_torch.utils import trace
    g = cpu_graph
    g.upsample = upsample
    ptrs = {k: t.data_ptr() for k, t in _after(g).items()}
    bases = []
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            for edit, kw in _edits(g, lowest):
                edit(g)
                want = _slice_update(g, **kw)
                g.update(**kw)
                bases.append(int(g._steps.inputs[-3]))
                for k, t in _after(g).items():
                    torch.testing.assert_close(t, want[k], rtol=0, atol=0,
                                               msg=k)
    finally:
        trace.disable()
    assert {k: t.data_ptr() for k, t in _after(g).items()} == ptrs
    assert torch.isfinite(g.video.poses).all()
    if lowest:
        assert len(set(bases)) > 1, bases
    c = trace.counters()
    assert c["update.calls"] == len(bases)
    assert c["update.replays"] == 0 and "update.captures" not in c
    assert not g._steps.graphs and not g._steps.seen


def test_a_graph_counts_its_launches_at_each_replay(monkeypatch):
    """``_StepGraphs.run`` as on the card, with a stand-in for the
    capture that runs the step's Python (as a capture does) but none of
    its work: a key's first run is eager, its second captures and
    replays, later ones replay; the step's launch counts once a run of
    its work, 5 in 5 runs, and the capture's counts are taken back.  Off
    CUDA every run is eager."""
    from goslam_tpu_torch.tracking.factor_graph import _StepGraphs
    from goslam_tpu_torch.utils import trace
    done = []

    def step():
        done.append("run")
        trace.launch("edge_system")

    class Recorded:
        def replay(self):
            done.append("run")

    def capture(step):
        step()
        done.pop()                 # recorded, not run
        return Recorded()

    card = _StepGraphs(4, torch.device("cpu"))
    card.cuda = True               # keys are remembered, as on CUDA
    monkeypatch.setattr(card, "_capture", capture)
    cpu = _StepGraphs(4, torch.device("cpu"))
    monkeypatch.setattr(cpu, "_capture", None)
    trace.reset()
    trace.enable()
    try:
        for key in ("a", "a", "a", "a", "b"):
            card.run(key, step)
        counted = trace.counters()
        trace.reset()
        for key in ("a", "a", "a"):
            cpu.run(key, step)
    finally:
        trace.disable()
    assert done == ["run"] * 8
    assert counted["launch.edge_system"] == 5
    assert counted["update.captures"] == 1
    assert counted["update.replays"] == 3
    assert set(card.graphs) == {"a"} and card.seen == {"a", "b"}
    assert card.graphs["a"][1] == {"launch.edge_system": 1}
    c = trace.counters()
    assert c["launch.edge_system"] == 3 and c["update.replays"] == 0
    assert "update.captures" not in c and not cpu.graphs and not cpu.seen


def test_the_fillers_one_graph_gives_a_fresh_graphs_poses(cpu_slam,
                                                         monkeypatch):
    """The trajectory filler over 10 frames in batches of 4 with one
    factor graph for the call (stale slots left by the batch before)
    and with a fresh graph for every batch: the same poses."""
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    slam = cpu_slam
    filler = slam.traj_filler
    ds = Synthetic(slam.cfg)

    def stream():
        for i in range(10):
            _, img, depth, intr, gt = ds[i]
            yield float(i) + 0.5, img, depth, intr, gt

    monkeypatch.setattr(filler, "batch", 4)
    graphs = []
    fill = filler._fill_batch

    def counted(graph, *a):
        graphs.append(graph)
        return fill(graph, *a)

    monkeypatch.setattr(filler, "_fill_batch", counted)
    one = filler(stream())
    assert len(graphs) == 3 and len(set(map(id, graphs))) == 1

    def fresh(graph, *a):
        return fill(FactorGraph(graph.video, graph.model,
                                max_factors=graph.max_factors,
                                corr_impl="volume", inac_capacity=-1), *a)

    monkeypatch.setattr(filler, "_fill_batch", fresh)
    each = filler(stream())
    assert one.shape == (10, 7) and np.isfinite(one).all()
    np.testing.assert_array_equal(one, each)


def _fill_slots(g, n):
    """Make free slots live until n are, each with a copy of a live edge's
    endpoints, set up as ``add_factors`` sets up a new edge."""
    free, live = np.flatnonzero(~g.valid), np.flatnonzero(g.valid)
    free = free[:max(0, n - len(live))]
    src = live[np.arange(len(free)) % len(live)]
    g.ii[free], g.jj[free] = g.ii[src], g.jj[src]
    g.age[free] = 0
    g.valid[free] = True
    g._write_new_edges(g._t(g.ii[free]), g._t(g.jj[free]), g._t(free))


def _drop_to(g, n):
    """Remove the newest live edges until n are left."""
    mask = np.zeros(g.cap, bool)
    mask[np.flatnonzero(g.valid)[n:]] = True
    g.rm_factors(mask)


@pytest.mark.parametrize("live", [40, 96])
def test_the_update_operator_runs_over_the_live_edges_bucket(cpu_graph,
                                                            live):
    """Two steps, the second after the live edges drop to the next
    smaller bucket's size, from 40 live edges (a bucket of 48 of the
    graph's 96 slots) and from every slot live: the staged slot list holds
    each live slot once, in slot order, and pads with distinct invalid
    slots only; the invalid slots' hidden states, targets and weights
    keep their bytes; the step equals the all-slot step; and
    ``update.slots`` sums bucket(live edges) over the calls."""
    from goslam_tpu_torch.utils import trace
    from goslam_tpu_torch.utils.shapes import bucket
    g = cpu_graph
    state = _save(g)
    slots_sum = 0
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            _drop_to(g, live)
            _fill_slots(g, live)
            for call in range(2):
                n = g.n_edges()
                if call:
                    _drop_to(g, max(b for b in (8, 16, 24, 32, 48, 64)
                                    if b < bucket(n)))
                    n = g.n_edges()
                B = bucket(n)
                assert n == (live if not call else B)
                assert (B == g.cap) == (live == g.cap and not call)
                slots_sum += B
                dead = np.flatnonzero(~g.valid)
                kept = {k: t[dead].clone() for k, t in _after(g).items()
                        if k in ("net", "target", "weight")}
                want = _slice_update(g, use_inactive=True)
                g.update(use_inactive=True)
                slots = g._slot_list(B).cpu().numpy()
                np.testing.assert_array_equal(slots[:n],
                                              np.flatnonzero(g.valid))
                assert len(np.unique(slots)) == B
                assert ((slots >= 0) & (slots < g.cap)).all()
                assert not g.valid[slots[n:]].any()
                for k, t in kept.items():
                    assert torch.equal(_after(g)[k][dead], t), k
                for k, t in _after(g).items():
                    torch.testing.assert_close(t, want[k], rtol=0, atol=0,
                                               msg=k)
        c = trace.counters()
    finally:
        trace.disable()
        _restore(g, state)
    assert c["update.calls"] == 2
    assert c["update.slots"] == slots_sum


def test_slot_layouts_of_one_bucket_share_one_graph(cpu_graph):
    """``_StepGraphs.run`` as on the card, with a stand-in capture that
    keeps the step function and a replay that runs the kept function:
    the step's graph key holds the bucket; the same live edges moved to
    other slots (one bucket) replay the graph captured from the first
    layout, and that replay equals the all-slot step of the new layout;
    fewer live edges, in a smaller bucket, make a new key.  40 live
    edges: a bucket of 48 of the graph's 96 slots."""
    from goslam_tpu_torch.tracking.factor_graph import _StepGraphs
    from goslam_tpu_torch.utils.shapes import bucket
    g = cpu_graph
    state, old = _save(g), g._steps
    steps = g._steps = _StepGraphs(old.inputs.numel(), g.video.device)
    steps.cuda = True              # keys are remembered, as on CUDA

    class Kept:
        def __init__(self, step):
            self.replay = step

    steps._capture = Kept
    kw = {"use_inactive": True}
    try:
        with torch.no_grad():
            _drop_to(g, 40)
            _fill_slots(g, 40)
            B = bucket(g.n_edges())
            assert B == 48
            g.update(**kw)             # eager
            g.update(**kw)             # captured and replayed
            (key,) = steps.graphs
            assert key[1] == B
            _permute_slots(g, 3)
            want = _slice_update(g, **kw)
            g.update(**kw)             # the first layout's graph
            assert set(steps.graphs) == {key}
            for k, t in _after(g).items():
                torch.testing.assert_close(t, want[k], rtol=0, atol=0,
                                           msg=k)
            small = max(b for b in (8, 16, 24, 32, 48) if b < B)
            _drop_to(g, small)
            g.update(**kw)
            g.update(**kw)
    finally:
        g._steps = old
        _restore(g, state)
    assert sorted(k[1] for k in steps.graphs) == [small, B]


def _problem(seed=0, P=6, E=10, ht=4, wd=6):
    g = np.random.default_rng(seed)
    poses = np.zeros((P, 7), np.float32)
    poses[:, 2] = 0.05 * np.arange(P)
    poses[:, 6] = 1.0
    disps = (0.5 + g.random((P, ht, wd))).astype(np.float32)
    ii = np.asarray([0, 0, 0, 0, 1, 2, 3, 4, 5, 1])[:E]
    jj = np.asarray([1, 2, 3, 4, 2, 3, 4, 5, 4, 0])[:E]
    target = (g.random((E, ht, wd, 2)) * [wd, ht]).astype(np.float32)
    weight = g.random((E, ht, wd, 2)).astype(np.float32)
    t = torch.from_numpy
    return (t(poses), t(disps), torch.tensor([4.0, 4.0, 3.0, 2.0]),
            torch.zeros(P, ht, wd), t(target), t(weight),
            torch.full((P, ht, wd), 1e-3), t(ii), t(jj),
            torch.ones(E, dtype=torch.bool))


def test_ba_with_the_host_degree_raises_the_same_error(monkeypatch):
    """Frame 0 sources four edges: over max_deg=2, ba() raises the same
    ValueError whether it reads the degree from the device or is given
    it; given it, it reads nothing from the device; at the capacity it
    runs."""
    from goslam_tpu_torch.ops import dba
    prob = _problem()
    with pytest.raises(ValueError, match="max_deg") as read:
        dba.ba(*prob, 1, 6, max_deg=2)
    monkeypatch.setattr(torch, "bincount", None)   # a device read fails
    with pytest.raises(ValueError, match="max_deg") as given:
        dba.ba(*prob, 1, 6, max_deg=2, deg=4)
    assert str(given.value) == str(read.value)
    p, d = dba.ba(*prob, 1, 6, max_deg=4, deg=4)
    assert torch.isfinite(p).all() and torch.isfinite(d).all()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _tensors(g):
    v = g.video
    return [v.poses, v.disps, v.damping, v.disps_up, g.net, g.target,
            g.weight, g.target_inac, g.weight_inac, *g.pyramid]


_HOST = ("ii", "jj", "age", "valid", "ii_inac", "jj_inac", "valid_inac")


def _save(g):
    return ([t.clone() for t in _tensors(g)],
            {k: getattr(g, k).copy() for k in _HOST}, g.video.dirty.copy())


def _restore(g, state):
    dev, host, dirty = state
    for t, s in zip(_tensors(g), dev):
        t.copy_(s)
    for k, a in host.items():
        getattr(g, k)[:] = a
    g.video.dirty[:] = dirty


def _permute_slots(g, seed):
    """Move every edge, live and archived, to other slots of the same
    table: the same graph in another slot layout."""
    rng = np.random.default_rng(seed)
    for n, host, dev in (
            (g.cap, ("ii", "jj", "age", "valid"),
             [g.net, g.target, g.weight, *g.pyramid]),
            (g.cap_inac, ("ii_inac", "jj_inac", "valid_inac"),
             [g.target_inac, g.weight_inac])):
        p = rng.permutation(n)
        for k in host:
            getattr(g, k)[:] = getattr(g, k)[p]
        pt = torch.as_tensor(p, device=dev[0].device)
        for t in dev:
            t.copy_(t[pt])


def _results(g):
    return {k: t.clone() for k, t in _after(g).items()}


def _eager_step(g, **kw):
    """One update step run eagerly, whatever keys the graph has seen."""
    steps = g._steps
    kept = steps.graphs, steps.seen
    steps.graphs, steps.seen = {}, set()
    try:
        g.update(**kw)
    finally:
        steps.graphs, steps.seen = kept


def _gaps(a, b, pre, valid):
    """Relative gaps of b from a: the flow revision and weights of the
    live edges, the change of the poses and disparities (each run's
    change from the state `pre` both started from), and the damping
    (a step sets it afresh where a frame has edges)."""
    sel = torch.as_tensor(np.flatnonzero(valid), device=pre["target"].device)
    gaps = {"target": _rel((b["target"] - pre["target"])[sel],
                           (a["target"] - pre["target"])[sel])}
    gaps.update({k: _rel(b[k] - pre[k], a[k] - pre[k])
                 for k in ("poses", "disps")})
    gaps.update({k: _rel(b[k][sel] if k == "weight" else b[k],
                         a[k][sel] if k == "weight" else a[k])
                 for k in ("weight", "damping")})
    return gaps


def _window_low(g, t0):
    """The lowest frame the update step's window must hold (before the
    bucket and the clamp), as ``FactorGraph._update`` finds it."""
    ok = g.valid_inac & (g.ii_inac >= t0 - 3) & (g.jj_inac >= t0 - 3)
    return min(g.ii[g.valid].min(), g.jj[g.valid].min(), t0 - 1,
               g.ii_inac[ok].min(), g.jj_inac[ok].min())


def _edit_archived(g, t0):
    """Give the archived edge of most weight among those a step from t0
    reads another endpoint jj inside its window, keeping the window's
    lowest frame (so the step's key).  Returns (slot, new jj)."""
    low, t1 = _window_low(g, t0), g.video.counter
    ok = g.valid_inac & (g.ii_inac >= t0 - 3) & (g.jj_inac >= t0 - 3)
    w = g.weight_inac.mean(dim=(1, 2, 3)).cpu().numpy()
    for k in sorted(np.flatnonzero(ok), key=lambda k: -w[k]):
        old = g.jj_inac[k]
        for j in range(t1 - 1, t0 - 4, -1):
            if j in (old, g.ii_inac[k]):
                continue
            g.jj_inac[k] = j
            if _window_low(g, t0) == low:
                return int(k), j
            g.jj_inac[k] = old
    raise AssertionError("no archived edge to edit")


# the gap between a replay and an eager run of one step from one state:
# the same kernels on the same inputs, apart from the order of atomic
# adds (GraphAgg's and the edge system's sums)
ROUNDING = 1e-3


@pytest.mark.card
def test_replayed_steps_match_eager_steps_at_scan_shapes(card, tmp_path):
    """replica-rgbd.scan's shapes: 320x640 frames, 128 + 192 edge slots,
    bf16.  Every key of the sequence (base shift, added, removed and
    archived edges, a motion-only step) is first captured with the
    edges in another slot layout.  Then, from the start, each step is
    run eagerly and by replay from one saved state: flow revision,
    weights, damping, and the change of poses and disparities agree
    within ROUNDING, and each counts the same kernel launches.  Last, a
    step whose only change is one archived edge's endpoint: the replay
    follows it as the eager step does, and moves by far more than
    ROUNDING."""
    from goslam_tpu_torch.utils import trace
    g = _tracked(_cfg(320, 640, 48, 12, 25, 75, "bfloat16"), 14, "cuda",
                 tmp_path).frontend.graph
    assert (g.cap, g.cap_inac) == (128, 192)
    start = _save(g)
    with torch.no_grad():
        for seed in (1, 2):
            _restore(g, start)
            _permute_slots(g, seed)
            for edit, kw in _edits(g, 4):
                edit(g)
                g.update(**kw)
        n_graphs = len(g._steps.graphs)
        _restore(g, start)
        trace.reset()
        trace.enable()
        try:
            for step, (edit, kw) in enumerate(_edits(g, 4)):
                edit(g)
                here, pre = _save(g), _results(g)
                _eager_step(g, **kw)
                again = _results(g)
                _restore(g, here)
                was = trace.counters()
                _eager_step(g, **kw)
                eager = _results(g)
                mid = trace.counters()
                _restore(g, here)
                g.update(**kw)
                now = trace.counters()
                assert now["update.replays"] - mid["update.replays"] == 1
                launched = {k: now[k] - mid.get(k, 0) for k in now
                            if k.startswith("launch.")}
                assert launched == {k: mid[k] - was.get(k, 0) for k in mid
                                    if k.startswith("launch.")}, step
                assert launched["launch.edge_system"] == kw.get("iters", 2)
                gaps = _gaps(eager, _results(g), pre, g.valid)
                print(f"step {step}: replay {gaps}; eager twice "
                      f"{_gaps(eager, again, pre, g.valid)}")
                assert max(gaps.values()) < ROUNDING, (step, gaps)

            # the archived edge of most weight that the step reads gets
            # another endpoint, the step's key (its window) unchanged
            kw = _edits(g, 4)[3][1]
            here, pre = _save(g), _results(g)
            g.update(**kw)
            unedited = _results(g)
            _restore(g, here)
            k, j = _edit_archived(g, kw["t0"])
            edited = _save(g)
            _eager_step(g, **kw)
            eager = _results(g)
            _restore(g, edited)
            mid = trace.counters()
            g.update(**kw)
            now = trace.counters()
        finally:
            trace.disable()
    assert now["update.replays"] - mid["update.replays"] == 1
    assert now.get("update.captures", 0) == 0
    assert len(g._steps.graphs) == n_graphs
    replayed = _results(g)
    gaps = _gaps(eager, replayed, pre, g.valid)
    moved = _gaps(unedited, replayed, pre, g.valid)
    print(f"edited archived edge {k} -> {j}: {gaps}; moved {moved}")
    assert max(gaps.values()) < ROUNDING, gaps
    assert moved["poses"] > 10 * ROUNDING, moved
    assert all(torch.isfinite(t).all() for t in replayed.values())
