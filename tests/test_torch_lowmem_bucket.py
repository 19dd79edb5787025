"""The low-memory step (``FactorGraph.update_lowmem``, global BA and loop
closing) runs its per-edge work over a bucket of slots that holds every
live edge, ``bucket(live edges)``, and not over every slot.

Each case builds a keyframe store of synthetic frames at 64x96 (features
from the in-tree checkpoint's encoders, ground-truth poses and sensor
disparities with seeded noise), an alt-corr graph over it, and runs two
low-memory steps in fp32 twice from one state: as ``update_lowmem`` runs
them, and with the unbucketed arithmetic (``_gru_chunks`` and
``_agg_segments`` over every slot, then the same DBA).  The slabs, poses,
disparities and damping agree bit for bit; the invalid slots' hidden
states, targets and weights keep their bytes; ``update_lowmem.slots``
counts the bucket at each step.  Cases: a loop graph seeded from a
frontend graph with proposed loop edges; a layout with holes left by
evicted edges; more live edges than ``GRU_CHUNK``, so the bucket runs in
several chunks; a stereo graph with self-edges.  No JAX is imported.
"""
import os

import numpy as np
import pytest
import torch

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

N, HT, WD, BUF = 24, 64, 96, 32
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two threads for this file (the suite runs several workers on one
    machine), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """N synthetic frames through the checkpoint's encoders: feature maps
    of the frame and of a copy shifted by 4 pixels (a stereo right view),
    context features, sensor disparities, noisy poses and intrinsics."""
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.models.droidnet import DroidNet
    from goslam_tpu_torch.ops import lie
    from goslam_tpu_torch.tracking.motion_filter import normalize_images

    rng = np.random.default_rng(7)
    cfg = update_recursive(default_config(), {
        "cam": {"H_out": HT, "W_out": WD},
        "data": {"n_frames": N, "orbit_fraction": 1.2}})
    ds = Synthetic(cfg)
    items = [ds[i] for i in range(N)]
    net = DroidNet()
    net.load_state_dict(load_checkpoint(CKPT))
    net.eval()
    images = torch.from_numpy(np.concatenate([it[1] for it in items]))
    left = normalize_images(images)
    right = normalize_images(torch.roll(images, 4, dims=-2))
    with torch.no_grad():
        fmaps = torch.stack([net.fnet(left, torch.float32),
                             net.fnet(right, torch.float32)], 1)
        nets, inps = net.encode_context(left, torch.float32)
    depth = np.stack([it[2][3::8, 3::8] for it in items])
    sens = torch.from_numpy((1.0 / depth).astype(np.float32))
    w2c = torch.from_numpy(np.stack(
        [np.linalg.inv(it[4]) for it in items]).astype(np.float32))
    dxi = torch.from_numpy((0.01 * rng.standard_normal((N, 6))).astype(
        np.float32))
    dxi[0] = 0
    poses = lie.compose(lie.exp(dxi), lie.from_matrix(w2c))
    disps = sens * torch.from_numpy((1 + 0.05 * rng.standard_normal(
        tuple(sens.shape))).astype(np.float32))
    return dict(net=net, fmaps=fmaps, nets=nets, inps=inps, sens=sens,
                poses=poses, disps=disps,
                intr=torch.from_numpy(items[0][3] / 8.0))


def _video(fr, stereo=False):
    from goslam_tpu_torch.tracking.video import VideoBuffer
    v = VideoBuffer(BUF, HT, WD, "cpu", stereo=stereo)
    bf = torch.bfloat16
    v.poses[:N] = fr["poses"]
    v.disps[:N] = fr["disps"]
    v.disps_sens[:N] = fr["sens"]
    v.fmaps[:N] = fr["fmaps"][:, :v.rig].to(bf)
    v.nets[:N] = fr["nets"].to(bf)
    v.inps[:N] = fr["inps"].to(bf)
    v.intrinsics.copy_(fr["intr"])
    v.counter = N
    return v


def _graph(fr, max_factors, stereo=False):
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    return FactorGraph(_video(fr, stereo), fr["net"],
                       max_factors=max_factors, corr_impl="alt",
                       inac_capacity=-1, compute_dtype=torch.float32)


def _band(lo, hi, r, self_edges=False):
    ii, jj = np.meshgrid(np.arange(lo, hi), np.arange(lo, hi),
                         indexing="ij")
    keep = (np.abs(ii - jj) <= r) & ((ii != jj) | self_edges)
    return ii[keep], jj[keep]


def _state(g):
    v = g.video
    return {"poses": v.poses, "disps": v.disps, "damping": v.damping,
            "net": g.net, "target": g.target, "weight": g.weight}


def _unbucketed(g, t0, t1):
    """``update_lowmem(t0, t1, steps=STEPS, max_t=N)`` with the per-edge
    work over every slot: the chunked GRU and GraphAgg's edge side over
    all ``cap`` slots, then the same damping and DBA.  Runs on copies and
    returns the state after it; the graph and the video are left as they
    were."""
    from goslam_tpu_torch.tracking.factor_graph import CG_MIN_POSES
    from goslam_tpu_torch.utils.shapes import bucket
    v = g.video
    before = {k: t.clone() for k, t in _state(g).items()}
    net, target, weight = (t.clone() for t in (g.net, g.target, g.weight))
    Tb = bucket(min((N + 2) * v.rig, v.buffer * v.rig))
    P = bucket(t1)
    deg, max_deg = g._max_deg(np.clip(g.ii[g.valid], 0, P - 1))
    valid = torch.from_numpy(g.valid.copy())
    ii = torch.from_numpy(np.where(g.valid, g.ii, 0))
    jj = torch.from_numpy(np.where(g.valid, g.jj, 0))
    ii_r, jj_r = ii * v.rig, jj
    if v.stereo:
        jj_r = torch.where(valid, jj * 2 + (ii == jj).long(), 0)
    ii_loc = ii.clamp(0, P - 1)
    with torch.no_grad():
        for _ in range(STEPS):
            g._gru_chunks(g.model, g._feature_pyramid(Tb), v.poses, v.disps,
                          v.intrinsics, v.inps, net, target, weight, ii, jj,
                          ii_r, jj_r, valid, g.valid)
            eta, has = g._agg_head(*g._agg_segments(g.model, net, ii_loc,
                                                    valid, P))
            damping_w = torch.where(has[:, None, None], eta, v.damping[:P])
            v.damping[:P] = damping_w
            g._window_ba(torch.arange(P), damping_w, ii_loc,
                         jj.clamp(0, P - 1), target, weight, valid, t0, t1,
                         2, 1e-5, 1e-2, False, max_deg, deg,
                         solver="cg" if P >= CG_MIN_POSES else "chol")
    want = {"poses": v.poses.clone(), "disps": v.disps.clone(),
            "damping": v.damping.clone(), "net": net, "target": target,
            "weight": weight}
    for k in ("poses", "disps", "damping"):
        getattr(v, k).copy_(before[k])
    return want


def _check_bucketed_step(g, t0, t1):
    """Both runs from the graph's state; returns the bucket, the slots the
    step ran over and the counters."""
    from goslam_tpu_torch.utils import trace
    from goslam_tpu_torch.utils.shapes import bucket
    n = g.n_edges()
    B = bucket(n)
    live, dead = np.flatnonzero(g.valid), np.flatnonzero(~g.valid)
    kept = {k: t[dead].clone() for k, t in _state(g).items()
            if k in ("net", "target", "weight")}
    target_live = g.target[live].clone()
    want = _unbucketed(g, t0, t1)
    ran = []
    step = g._lowmem_step
    g._lowmem_step = lambda edges, *a: ran.append(
        edges[3].clone()) or step(edges, *a)
    trace.reset()
    trace.enable()
    try:
        g.update_lowmem(t0=t0, t1=t1, iters=2, steps=STEPS, max_t=N)
        c = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    for k, t in _state(g).items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)
    for k, t in kept.items():
        assert torch.equal(_state(g)[k][dead], t), k
    # the update operator ran at every live slot
    assert (g.target[live] != target_live).flatten(1).any(1).all()
    assert torch.isfinite(g.video.poses).all()
    assert len(ran) == STEPS
    slots = ran[0].numpy()
    assert all(torch.equal(r, ran[0]) for r in ran)
    assert len(slots) == B and len(np.unique(slots)) == B
    np.testing.assert_array_equal(slots[:n], live)
    assert not g.valid[slots[n:]].any()
    assert c["update_lowmem.slots"] == B * STEPS
    assert c["update_lowmem.steps"] == STEPS
    assert c["update_lowmem.edges"] == n
    return B, slots, c


def test_loop_graph_seeded_from_the_frontend(frames):
    """The loop-closing graph: the frontend's live edges over the last
    frames copied into the first slots (``seed_live_edges``), then the
    loop edges the proposal gives between the last window and the whole
    video, in a graph of 8 x window edges (cap 128)."""
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    from goslam_tpu_torch.tracking.proposal import propose_edges
    window = 8
    g = _graph(frames, 8 * window)
    front = FactorGraph(g.video, g.model, max_factors=24,
                        corr_impl="volume", compute_dtype=torch.float32)
    front.add_neighborhood_factors(N - 8, N, r=2)
    with torch.no_grad():
        front.update(t0=N - 7, t1=N)
    g.seed_live_edges(front)
    seeded = g.n_edges()
    es, _ = propose_edges(g.video, N - window, 0, N, 1, 1, 100.0,
                          8 * window - seeded, 0.3, True,
                          near_from=N - window)
    ii, jj = np.asarray(sorted(set(es)), np.int64).T
    g.add_factors(ii, jj, remove=True)
    n = g.n_edges()
    assert seeded == front.n_edges() and n > seeded + 8
    assert (g.jj[g.valid] < N - window).any()        # a loop edge
    B, _, _ = _check_bucketed_step(g, N - window + 1, N)
    assert B < g.cap


def test_holes_left_by_evicted_edges(frames):
    """A band graph (90 edges) whose oldest edges, by seeded ages, were
    evicted for 10 new ones (``add_factors`` with ``remove``, down to 64
    live): the live slots are scattered over the first 90 of the 128
    slots, and the bucket of 64 gathers them."""
    g = _graph(frames, 64)
    g.add_factors(*_band(0, N, 2))
    assert g.n_edges() == 90
    g.age[g.valid] = np.random.default_rng(3).permutation(90)
    ii = np.arange(0, 10)
    g.add_factors(ii, ii + 5, remove=True)
    live = np.flatnonzero(g.valid)
    assert len(live) == 64 and live[-1] == 89
    B, slots, _ = _check_bucketed_step(g, 1, N)
    assert B == 64 and set(slots) == set(live)


def test_more_live_edges_than_one_chunk(frames):
    """Over GRU_CHUNK live edges (a band of radius 8 over 24 frames, 312
    edges): the bucket of 384 of the graph's 512 slots runs as a chunk of
    256 and one of 128."""
    from goslam_tpu_torch.tracking.factor_graph import GRU_CHUNK
    g = _graph(frames, 400)
    g.add_factors(*_band(0, N, 8))
    assert g.n_edges() == 312 > GRU_CHUNK and g.cap == 512
    B, _, _ = _check_bucketed_step(g, 1, N)
    assert B == 384


def test_stereo_self_edges(frames):
    """A stereo graph with a self-edge at every frame (left against right
    view) beside a band of radius 2: a self-edge's jj map is the right
    view, in the bucket as over every slot."""
    g = _graph(frames, 96, stereo=True)
    ii, jj = _band(0, 16, 2, self_edges=True)
    g.add_factors(ii, jj)
    assert g.video.stereo and (g.ii[g.valid] == g.jj[g.valid]).sum() == 16
    B, slots, _ = _check_bucketed_step(g, 1, 16)
    assert B < g.cap


def test_the_counter_sums_the_bucket_over_calls(frames):
    """``update_lowmem.slots`` adds bucket(live edges) x steps at each
    call: 3 calls of 1, 2 and 3 steps at 20, 40 and 70 live edges."""
    from goslam_tpu_torch.utils import trace
    from goslam_tpu_torch.utils.shapes import bucket
    ii, jj = _band(0, N, 8)
    want = 0
    trace.reset()
    trace.enable()
    try:
        for steps, n in ((1, 20), (2, 40), (3, 70)):
            g = _graph(frames, 96)
            g.add_factors(ii[:n], jj[:n])
            g.update_lowmem(t0=1, t1=N, steps=steps, max_t=N)
            want += bucket(n) * steps
        c = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert c["update_lowmem.calls"] == 3 and c["update_lowmem.steps"] == 6
    assert c["update_lowmem.slots"] == want == 24 + 2 * 48 + 3 * 96
