"""Mono and stereo tracking in the port against the JAX package, on the CPU.

Both packages run ``SLAMSystem`` tracking-only in ``mono`` and in
``stereo`` over the same 8-frame ``Synthetic`` sequence at 64x96 with
the in-tree checkpoint, as ``test_torch_slice.py`` does in RGB-D (its
overrides: every frame admitted, none removed, fp32 frontend and
backend, global BA every 4 keyframes; in mono none during tracking,
see ``_cfg``).  No depth is given; in stereo
each frame is [left, right], the right view rendered 0.1 m along the
camera's x axis (``chip_smoke.stereo_right``), the baseline the port's
stereo self-edges assume.  The JAX package runs in a process of its own
(tests/jax_subprocess.py).

Without depth the runs are chaotic in fp32.  The motion filter
encodes the keyframes in bf16 in both packages, and the two round
differently at a few entries (ROADMAP C1): tracked with their own
features the two packages' trajectories part by 5-16 cm, ATE by 17-28 %,
beyond test_torch_slice.py's gates (12 frames).  Given the JAX
package's features (as ``test_torch_demo_tracking.py`` does) they still
part, by 3-5 cm at the end: one bf16 step (1e-2) in one hidden-state
entry of one keyframe moves the port's own run as far.  So each
admitted keyframe's features (fmaps, both views in stereo; hidden
state; context) are replaced by the JAX package's, and after every
frontend update and every global BA during tracking the port's poses
are held to the JAX package's, then set to them (and the disparities
too) before the next step: every step starts from the JAX package's
state.  The frontend's
edge set (in stereo with its self-edges) must equal the JAX package's;
``terminate`` (two final global BAs, the trajectory filler, ATE) must
give finite poses for every frame.

Also held against the JAX package at the index level: the maps the
global BA's alt-corr reads in a stereo graph (the rig-flattened
feature pyramid and each edge's map in it).  And the stereo rig's
convention: the rendered right view agrees with the tracker's baseline;
a stereo go.ckpt resumes both views.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax_subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

MODES = ("mono", "stereo")
N_FRAMES = 8
HT, WD = 64, 96
OVERRIDES = {
    "dataset": "synthetic", "multichip": False,
    "cam": {"H": HT, "W": WD, "H_out": HT, "W_out": WD,
            "H_edge": 0, "W_edge": 0},
    # the first 8 frames of test_torch_slice.py's 12-frame orbit
    "data": {"input_folder": "", "n_frames": N_FRAMES,
             "orbit_fraction": 0.5 * N_FRAMES / 12},
    "tracking": {
        "buffer": 32, "warmup": 4, "compute_dtype": "float32",
        "motion_filter": {"thresh": -1.0},
        "frontend": {"window": 6, "max_factors": 24, "enable_loop": False,
                     "keyframe_thresh": 0.0},
        "global_ba_every": 4,
    },
}
# from the same state and features: the largest pose entry difference
# after a frontend update (readings: 4.8e-6 in mono, 6.5e-6 in stereo),
# and after a global BA, two steps of the low-memory update (stereo:
# 6.9e-5; the port's own run moves as far when one hidden-state entry
# moves by 1e-2).  Stereo self-edges reading the left view instead of
# the right read 5.5e-3 (frontend) and 1.1e-2 (global BA)
FRONTEND_TOL = 1e-4
GLOBAL_BA_TOL = 1e-3
# states of the run: 16 frontend updates once the 4 warm-up keyframes
# are in, 6 for each of the 4 keyframes after them, and in stereo the
# global BA at keyframe 8
N_STATES = {"mono": {"frontend": 16 + 6 * 4, "global_ba": 0},
            "stereo": {"frontend": 16 + 6 * 4, "global_ba": 1}}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once, and
    more threads than cores slow torch's small operations many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(update_recursive, default_config, mode):
    cfg = update_recursive(default_config(), copy.deepcopy(OVERRIDES))
    cfg["mode"] = mode
    if mode == "mono":
        # the JAX package's first global BA in mono does not repeat here:
        # from the same inputs (every earlier state equal bit for bit)
        # 2 of 7 fresh processes land 4 cm from the other 5 (the map has
        # shrunk to disparities of 10-120 by then); stereo's agree in
        # 11 of 11.  Mono's global BA is RGB-D's code (test_torch_slice)
        cfg["tracking"]["global_ba_every"] = 0
    return cfg


def _track(slam, frames, graph_cls, feats=None, forced=None):
    """Track `frames` (chip_smoke.mode_frames), recording the keyframe
    poses and disparities after every FactorGraph.update (the frontend's)
    and every global BA (``Backend.dense_ba``), each tagged with its
    kind; with `feats`, each admitted keyframe's features are replaced
    by those, and with `forced` (the states another run recorded) the
    poses and disparities are set to forced[k] once state k is recorded
    (the port only).  Returns the recorded states, the frontend's live
    edges at the end and the edges each global BA proposed."""
    v, states = slam.video, []
    update, dense_ba = graph_cls.update, slam.backend.dense_ba

    def record(kind):
        n = v.counter
        states.append((kind, np.array(v.poses[:n]), np.array(v.disps[:n])))
        if forced is not None and len(states) <= len(forced):
            _, p, d = forced[len(states) - 1]
            v.poses[:n] = torch.from_numpy(p)
            v.disps[:n] = torch.from_numpy(d)

    def recorded(self, *a, **k):
        out = update(self, *a, **k)
        record("frontend")
        return out

    def recorded_ba(*a, **k):
        out = dense_ba(*a, **k)
        record("global_ba")
        return out

    propose, proposed = slam.backend._propose_edges, []

    def recorded_propose(*a, **k):
        es = propose(*a, **k)
        proposed.append(sorted(set(es)))
        return es

    slam.backend.dense_ba = recorded_ba
    slam.backend._propose_edges = recorded_propose
    if feats is not None:
        track = slam.motion_filter.track

        def track_with(*a, **k):
            admitted = track(*a, **k)
            if admitted:
                kf = v.counter - 1
                for name in feats:
                    buf = getattr(v, name)
                    buf[kf] = torch.from_numpy(feats[name][kf]).to(buf.dtype)
            return admitted

        slam.motion_filter.track = track_with
    graph_cls.update = recorded
    try:
        for i, (img, depth, intr, gt) in enumerate(frames):
            slam.track(float(i), img, depth, intr, gt)
        slam.flush()
    finally:
        graph_cls.update = update
        slam.backend.dense_ba = dense_ba
        slam.backend._propose_edges = propose
    g = slam.frontend.graph
    edges = sorted(zip(np.asarray(g.ii)[g.valid].tolist(),
                       np.asarray(g.jj)[g.valid].tolist()))
    return states, edges, proposed


def _jax_main(out):
    """Both modes' tracking in the JAX package, in a process of its own."""
    from chip_smoke import mode_frames
    from goslam_tpu.config import default_config, update_recursive
    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.system import SLAMSystem, load_pretrained
    from goslam_tpu.tracking.factor_graph import FactorGraph

    params = load_pretrained(CKPT)
    runs = {}
    for mode in MODES:
        cfg = _cfg(update_recursive, default_config, mode)
        slam = SLAMSystem(cfg, params=params, output=out,
                          only_tracking=True)
        states, edges, proposed = _track(
            slam, mode_frames(cfg, Synthetic(cfg)), FactorGraph)
        v, n = slam.video, slam.video.counter
        runs[mode] = dict(states=states, edges=edges, n_kf=n,
                          proposed=proposed, feats={
            k: np.asarray(getattr(v, k)[:n], np.float32)
            for k in ("fmaps", "nets", "inps")})
    return runs


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_subprocess.run("test_torch_modes",
                              str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Both modes in the port with the JAX package's features, then
    terminate."""
    from chip_smoke import mode_frames
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph

    sd = load_checkpoint(CKPT)
    runs = {}
    for mode in MODES:
        cfg = _cfg(update_recursive, default_config, mode)
        out = str(tmp_path_factory.mktemp(mode))
        slam = SLAMSystem(cfg, state_dict=sd, output=out,
                          only_tracking=True, device="cpu")
        frames = mode_frames(cfg, Synthetic(cfg))
        states, edges, proposed = _track(
            slam, frames, FactorGraph, jax_runs[mode]["feats"],
            forced=jax_runs[mode]["states"])
        n_kf = slam.video.counter
        metrics = slam.terminate(
            (float(i),) + tuple(f) for i, f in enumerate(frames))
        runs[mode] = dict(states=states, edges=edges, n_kf=n_kf,
                          proposed=proposed, metrics=metrics, out=out,
                          fmaps=slam.video.fmaps[:n_kf].clone(), rig=slam.video.rig,
                          est=np.load(os.path.join(out, "est_poses.npy")))
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_keyframe_count_matches_jax(mode, jax_runs, port_runs):
    assert port_runs[mode]["n_kf"] == jax_runs[mode]["n_kf"] == N_FRAMES
    assert port_runs[mode]["rig"] == (2 if mode == "stereo" else 1)


@pytest.mark.parametrize("mode", MODES)
def test_each_step_matches_jax_given_its_state(mode, jax_runs, port_runs):
    """Every frontend update and every global BA of the run, each from
    the JAX package's poses, disparities and keyframe features: the
    keyframe poses within FRONTEND_TOL / GLOBAL_BA_TOL of the JAX
    package's."""
    a, b = port_runs[mode]["states"], jax_runs[mode]["states"]
    assert [k for k, *_ in a] == [k for k, *_ in b]
    gaps = {"frontend": [], "global_ba": []}
    for (kind, pa, _), (_, pb, _) in zip(a, b):
        assert pa.shape == pb.shape
        gaps[kind].append(float(np.abs(pa - pb).max()))
    assert {k: len(g) for k, g in gaps.items()} == N_STATES[mode]
    assert max(gaps["frontend"]) <= FRONTEND_TOL, gaps["frontend"]
    assert max(gaps["global_ba"], default=0.0) <= GLOBAL_BA_TOL, \
        gaps["global_ba"]


@pytest.mark.parametrize("mode", MODES)
def test_frontend_edges_match_jax(mode, jax_runs, port_runs):
    """The frontend's live edge set at the end of tracking equals the
    JAX package's; in stereo it holds self-edges (i, i), in mono none."""
    edges = port_runs[mode]["edges"]
    assert edges == jax_runs[mode]["edges"]
    n_self = sum(i == j for i, j in edges)
    assert (n_self > 0) == (mode == "stereo")


def test_stereo_global_ba_edges_match_jax(jax_runs, port_runs):
    """The edges each global BA during stereo tracking proposed equal the
    JAX package's, every keyframe's self-edge among them."""
    got, want = port_runs["stereo"]["proposed"], jax_runs["stereo"]["proposed"]
    assert len(got) == N_STATES["stereo"]["global_ba"]
    assert got == want
    for es in got:
        frames = {i for e in es for i in e}
        assert {i for i, j in es if i == j} == frames


@pytest.mark.parametrize("mode", MODES)
def test_terminate_fills_every_frame(mode, port_runs):
    """terminate after mono and stereo tracking: finite c2w poses for
    every frame and an ATE against the synthetic ground truth."""
    est = port_runs[mode]["est"]
    assert est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all()
    ate = port_runs[mode]["metrics"]["ate"]
    assert ate["n_poses"] == N_FRAMES
    assert np.isfinite(ate["rmse"]) and ate["scale"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_mapping_takes_the_same_code_in_every_mode(mode, tmp_path):
    """The mapper reads the tracker's filtered disparities whatever the
    mode: a mono or stereo system with mapping on builds, with its
    multiview filter and mapper."""
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.system import SLAMSystem
    cfg = _cfg(update_recursive, default_config, mode)
    cfg["only_tracking"] = False
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    assert slam.mapper is not None and slam.multiview_filter is not None


def test_stereo_checkpoint_keeps_both_views(port_runs, tmp_path):
    """go.ckpt of the stereo run carries fmaps [n, 2, ...]: a stereo
    system resumes both views, a mono one refuses it."""
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.system import SLAMSystem
    ckpt = os.path.join(port_runs["stereo"]["out"], "go.ckpt")
    for mode in MODES:
        slam = SLAMSystem(_cfg(update_recursive, default_config, mode),
                          output=str(tmp_path / mode), only_tracking=True,
                          device="cpu")
        if mode == "mono":
            with pytest.raises(ValueError, match="view"):
                slam.load_checkpoint(ckpt)
            assert slam.video.counter == 0
            continue
        slam.load_checkpoint(ckpt)
        n = port_runs["stereo"]["n_kf"]
        assert slam.video.counter == n
        assert torch.equal(slam.video.fmaps[:n], port_runs["stereo"]["fmaps"])
        assert slam.motion_filter.fmap.shape[0] == 2


@pytest.mark.parametrize("frame", [0, 7])
def test_stereo_right_view_takes_the_trackers_baseline(frame):
    """chip_smoke.stereo_right's convention: each left pixel, moved by
    its rendered depth through a stereo self-edge (ii == jj, the fixed
    baseline), lands on the right image's matching texel (mean colour
    error < 1e-3, bilinear in a smooth texture; readings 6.1e-5 and
    4.8e-5); moved the other way (the right camera at -0.1 m) it does
    not (0.047 and 0.069)."""
    import torch.nn.functional as F

    from chip_smoke import stereo_right
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.ops import lie, projective

    ds = Synthetic(update_recursive(default_config(), {
        "cam": {"H_out": HT, "W_out": WD}, "data": {"n_frames": N_FRAMES}}))
    _, left, depth, intr, _ = ds[frame]
    right = torch.as_tensor(stereo_right(ds)[frame][1]).permute(0, 3, 1, 2)
    ii = torch.zeros(1, dtype=torch.long)
    coords, _ = projective.transform(
        lie.identity((1,)), torch.as_tensor(1.0 / depth)[None],
        torch.as_tensor(intr), ii, ii)
    grid = projective.coords_grid(HT, WD)
    errs = []
    for c in (coords[0], 2 * grid - coords[0]):
        g = torch.stack([2 * c[..., 0] / (WD - 1) - 1,
                         2 * c[..., 1] / (HT - 1) - 1], -1)[None]
        seen = F.grid_sample(right, g, align_corners=True)[0]
        inside = (c[..., 0] >= 0) & (c[..., 0] <= WD - 1)
        diff = np.abs(seen.permute(1, 2, 0).numpy() - left[0])
        errs.append(float(diff[inside.numpy()].mean()))
    # the baseline moves pixels by a few pixels at this size
    assert float((grid - coords[0])[..., 0].mean()) > 2.0
    assert errs[0] < 1e-3 < errs[1], errs


class _Recorded(Exception):
    pass


def _stereo_graph_edges():
    """A stereo graph of 5 frames: self-edges, neighbours both ways, a
    long edge, and slots left invalid."""
    ii = np.asarray([0, 1, 2, 3, 4, 0, 2, 1, 3, 4], np.int64)
    jj = np.asarray([0, 1, 2, 3, 4, 2, 0, 3, 1, 0], np.int64)
    return ii, jj


def test_lowmem_stereo_pyramid_indices_match_jax(monkeypatch):
    """update_lowmem in stereo: the feature maps the alt-corr pyramid is
    built from (the first Tb // rig frames, both views, rig-flattened)
    and each edge's pair of maps in it (ii * 2, and jj * 2 + 1 for a
    self-edge, jj * 2 otherwise; invalid slots 0) equal the JAX
    package's, read where each package hands them to its alt-corr."""
    import jax.numpy as jnp

    from goslam_tpu.tracking import factor_graph as jfg
    from goslam_tpu.tracking.video import VideoBuffer as JVideo
    from goslam_tpu_torch.models.droidnet import init_droidnet
    from goslam_tpu_torch.ops import corr
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    from goslam_tpu_torch.tracking.video import VideoBuffer

    ii, jj = _stereo_graph_edges()
    n, buf = 5, 16
    rng = np.random.default_rng(0)
    fmaps = rng.standard_normal((n, 2, HT // 8, WD // 8, 128)).astype(
        np.float32)

    # the JAX package: record what _lowmem_step hands its kernel
    seen = {}

    def jax_kernel(P, cap, chunk, nchunks, max_deg, Tb, params, poses,
                   disps, disps_sens, damping, intrinsics, inps_v, fm, net,
                   target, weight, ii_, jj_, ii_r, jj_r, valid, *rest,
                   **kw):
        seen.update(Tb=Tb, rig=fm.shape[1], ii_r=np.asarray(ii_r),
                    jj_r=np.asarray(jj_r), valid=np.asarray(valid))
        raise _Recorded

    monkeypatch.setattr(jfg, "_lowmem_kernel", jax_kernel)
    jv = JVideo(buffer=buf, ht=HT, wd=WD, stereo=True)
    jv.counter = n
    jv.fmaps = jv.fmaps.at[:n].set(jnp.asarray(fmaps, jnp.bfloat16))
    jg = jfg.FactorGraph(jv, {}, max_factors=16, corr_impl="alt",
                         inac_capacity=-1)
    jg.add_factors(ii, jj)
    with pytest.raises(_Recorded):
        jg.update_lowmem(t0=1, t1=n, steps=1)
    jax_maps = min(seen["Tb"] // seen["rig"], buf) * seen["rig"]
    jvalid = seen["valid"]

    # the port: record what _lowmem_step hands corr.alt_corr
    got = []

    def port_alt_corr(levels, coords, ii_r, jj_r):
        got.append((levels[0].shape[0], levels[0].clone(), ii_r.clone(),
                    jj_r.clone()))
        raise _Recorded

    monkeypatch.setattr(corr, "alt_corr", port_alt_corr)
    v = VideoBuffer(buf, HT, WD, "cpu", stereo=True)
    v.counter = n
    v.fmaps[:n] = torch.as_tensor(fmaps).to(torch.bfloat16)
    g = FactorGraph(v, init_droidnet(), max_factors=16, corr_impl="alt",
                    inac_capacity=-1)
    g.add_factors(ii, jj)
    assert np.array_equal(g.valid, jvalid)
    with pytest.raises(_Recorded):
        g.update_lowmem(t0=1, t1=n, steps=1)
    maps, level0, ii_r, jj_r = got[0]
    assert maps == jax_maps == 2 * min(seen["Tb"] // 2, buf)
    # the port hands its alt-corr the bucket's slots (one chunk here)
    slots = g._bucket_slots(len(ii_r))
    # the JAX kernel masks them with the validity (invalid slots read
    # map 0)
    jii = np.where(jvalid, seen["ii_r"], 0)
    jjj = np.where(jvalid, seen["jj_r"], 0)
    np.testing.assert_array_equal(ii_r.numpy(), jii[slots])
    np.testing.assert_array_equal(jj_r.numpy(), jjj[slots])
    # the pyramid's map k * 2 + r is frame k's view r, at full resolution
    # on level 0
    flat = v.fmaps[:maps // 2].reshape(-1, HT // 8, WD // 8, 128)
    assert torch.equal(level0, corr.build_feature_pyramid(flat)[0])
    # self-edges read the right view of their frame
    sel = g.valid[slots] & (g.ii[slots] == g.jj[slots])
    assert sel.any()
    assert (jj_r.numpy()[sel] == 2 * g.ii[slots][sel] + 1).all()
