"""GO-SLAM's Replica monocular configuration (``configs/Replica/
replica_mono.yaml``, the benchmark's ``replica-mono``) held against the
benchmark's plain reference (``benchmark/reference``), on the CPU.

The steps mono runs at its own capacities are driven directly from a
seeded keyframe buffer at 64x96 with no sensor depth, DroidNet at its
published widths with seeded random weights, in fp32, and compared by
the benchmark's own check (``harness/check.py``: the same captures, the
same reference steps, the same relative gaps):

  (a) a frontend update step in the 192-slot graph that max_factors 100
      makes, over a window of 50 keyframes, and its DBA with every
      sensor disparity 0;
  (b) loop closing's low-memory step in the 512-slot graph that its
      400-edge budget (8 x loop_window 50) makes;
  (c) a map step at 48 + 24 samples whose target depth is the multiview
      filter's filtered tracked disparity.

A control runs (a) in bf16, and with the sensor term applied where the
frame has none: each has to fail.  Then the configuration file against
the published YAML, and one whole ``replica-mono.scan`` run at 64x96
through the benchmark's ``run.run_cell`` (in a process of its own: the
benchmark refuses to run beside JAX, which this suite's conftest loads).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")
MONO_JSON = os.path.join(BENCH, "configs", "replica-mono.json")
if BENCH not in sys.path:
    sys.path.append(BENCH)        # harness, reference

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

HT, WD = 64, 96
N_KF = 60                 # keyframes in the seeded buffer

# Tolerances, each on the check's relative gap ||port - ref|| / ||ref||,
# read over three weight draws (and two buffers for (a)):
# - update (flow revision, weights): the port keeps the frontend's
#   correlation volume in bf16 (as the JAX package does) while the
#   reference correlates the fp32 features; the rest is fp32 on both
#   sides.  Read 2.4e-4 - 3.2e-4; the same steps in bf16 read 4.6e-3 -
#   5.8e-3.
UPDATE_TOL = 1.5e-3
# - dba (the window's pose and disparity change): the same DBA, fp32 on
#   both sides (K1 and the Cholesky solve in their plain versions).  Read
#   0 (the same sums in the same order); 1e-4 leaves room for another
#   order of sums.  A sensor term where a mono frame has none reads 0.98.
DBA_TOL = 1e-4
# - global_ba (loop closing's flow revision and weights after its two
#   low-memory steps): fp32 on both sides but for the order of sums in
#   the alt-corr over the feature pyramid and in the update operator;
#   the second step starts from the first's DBA, which carries the
#   first's rounding.  Read 9.4e-5 - 1.3e-4; in bf16 5.1e-3 - 6.5e-3.
LOWMEM_TOL = 1e-3
# - map_step (loss, clipped gradient): fp32 on both sides, the hash
#   grid's and the MLP's sums in another order.  Read 8e-8.
MAP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several workers on one machine; PyTorch's default of
    one thread per core in each of them makes them all wait on each
    other.  Two threads per worker for this file, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_ckpt(path, seed=5):
    """The checkpoint's parameter tree with every array redrawn from a
    seeded normal of the array's own spread: DroidNet at its published
    widths, random weights."""
    with open(CKPT, "rb") as f:
        state = pickle.load(f)
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        return (rng.standard_normal(a.shape) * a.std()).astype(np.float32)

    with open(path, "wb") as f:
        pickle.dump({"params": draw(state["params"])}, f)
    return path


def _mono_cfg(dtype="float32"):
    from goslam_tpu_torch.config import update_recursive
    with open(MONO_JSON) as f:
        cfg = json.load(f)["config"]
    return update_recursive(cfg, {
        "cam": {"H_out": HT, "W_out": WD},
        "tracking": {"compute_dtype": dtype},
        "mapping": {"pixels": 256, "mapping_window_size": 4}})


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the port's DroidNet, the reference's fp32 net), one random
    parameter draw."""
    from reference.net import Net, load_params

    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.models.droidnet import DroidNet
    path = _random_ckpt(str(tmp_path_factory.mktemp("ckpt") / "rand.ckpt"))
    net = DroidNet()
    net.load_state_dict(load_checkpoint(path))
    net.weight_calib.fill_(4.0)
    return net.eval(), Net(load_params(path, "cpu"), "fp32")


def _video(n=N_KF, seed=13):
    """A mono keyframe buffer (replica-mono's 256 slots): a smooth
    seeded path, disparities 0.4-0.7, random features and context, no
    sensor disparity anywhere."""
    from goslam_tpu_torch.ops import lie
    from goslam_tpu_torch.tracking.video import VideoBuffer
    g = torch.Generator().manual_seed(seed)
    v = VideoBuffer(256, HT, WD, "cpu")
    poses = [lie.identity()]
    for _ in range(n - 1):
        step = lie.exp(torch.cat([0.02 * torch.randn(3, generator=g),
                                  0.01 * torch.randn(3, generator=g)]))
        poses.append(lie.compose(step, poses[-1]))
    v.poses[:n] = torch.stack(poses)
    h8, w8 = v.h8, v.w8
    v.disps[:n] = 0.4 + 0.3 * torch.rand((n, h8, w8), generator=g)
    v.intrinsics.copy_(torch.tensor([6.0, 6.0, w8 / 2 - 0.5, h8 / 2 - 0.5]))
    bf16 = torch.bfloat16
    v.fmaps[:n] = torch.randn((n, 1, h8, w8, 128), generator=g).to(bf16)
    v.nets[:n] = torch.tanh(torch.randn((n, h8, w8, 128), generator=g)).to(
        bf16)
    v.inps[:n] = torch.relu(torch.randn((n, h8, w8, 128), generator=g)).to(
        bf16)
    v.counter = n
    return v


def _compare(run_steps, net_ref, edit_start=None):
    """Run `run_steps()` under the benchmark's capture and return the
    check's numbers: {number: worst gap}."""
    from harness import check
    cap = check.Capture(seed=1)
    cap.install()
    try:
        run_steps()
    finally:
        cap.remove()
    if edit_start is not None:
        for kind in check.SAMPLE:
            for item in cap.samples(kind):
                edit_start(kind, item["start"])
    return {k: c["worst"] for k, c in check.compare(cap, net_ref).items()}


def _frontend_graph(net, v, dtype=torch.float32):
    """replica-mono's frontend graph over the buffer: max_factors 100 ->
    192 edge slots, an inactive store of 256; 100 live edges over the
    50-keyframe window [10, 60) and 12 archived ones before it."""
    from goslam_tpu_torch.tracking.factor_graph import FactorGraph
    cfg = _mono_cfg()
    f = cfg["tracking"]["frontend"]
    g = FactorGraph(v, net, max_factors=f["max_factors"], corr_impl="volume",
                    upsample=True, inac_capacity=2 * f["max_factors"],
                    compute_dtype=dtype)
    old = [(i, i + 1) for i in range(4, 10)]
    g.add_factors(*np.array(old + [(j, i) for i, j in old]).T)
    g.rm_factors(g.valid.copy(), store=True)
    t0, t1 = N_KF - f["window"], N_KF
    pairs = [(i, i + 1) for i in range(t0, t1 - 1)] + [(t0, t0 + 2)]
    g.add_factors(*np.array(pairs + [(j, i) for i, j in pairs]).T)
    return g


def _update_steps(g, n=3):
    def run():
        for _ in range(n):
            g.update(use_inactive=True)
    return run


def test_the_frontend_step_at_192_slots_matches_the_reference(nets):
    """(a) Three update steps of the 192-slot frontend graph over a
    50-keyframe window, and their DBA with every sensor disparity 0."""
    net, ref = nets
    v = _video()
    g = _frontend_graph(net, v)
    assert (g.cap, g.cap_inac) == (192, 256)
    assert g.n_edges() == 100 and g.valid_inac.sum() == 12
    assert not bool(v.disps_sens.any())
    got = _compare(_update_steps(g), ref)
    assert got["update"] <= UPDATE_TOL, got
    assert got["dba"] <= DBA_TOL, got


def test_loop_closing_step_at_512_slots_matches_the_reference(nets):
    """(b) Loop closing's two low-memory steps in the 512-slot graph of
    its 400-edge budget: every pair within 4 keyframes over 50 keyframes
    and 20 loop edges 30 keyframes apart, 400 edges in all."""
    from goslam_tpu_torch.tracking.backend import Backend
    net, ref = nets
    v = _video()
    be = Backend(net, v, _mono_cfg())
    budget = 8 * be.backend_loop_window
    g = be._graph(budget)
    assert (budget, g.cap) == (400, 512)
    ii, jj = np.meshgrid(np.arange(50), np.arange(50), indexing="ij")
    near = (ii != jj) & (np.abs(ii - jj) <= 4)
    loops = [(i, i + 30) for i in range(10)]
    ii = np.concatenate([ii[near], [i for i, _ in loops],
                         [j for _, j in loops]])
    jj = np.concatenate([jj[near], [j for _, j in loops],
                         [i for i, _ in loops]])
    g.add_factors(ii, jj)
    assert g.n_edges() == 400

    def run():
        g.update_lowmem(t0=1, t1=50, iters=2, steps=2, max_t=50,
                        ba_type="dense")

    got = _compare(run, ref)
    assert got["global_ba"] <= LOWMEM_TOL, got


def _mapping_video(cfg, n=12):
    """A mono buffer whose tracked disparities are the room's true ones:
    the scan orbit's first n frames rendered at 64x96, the full-resolution
    disparity in disps_up (where tracking writes it), no sensor
    disparity."""
    from harness import scene

    from goslam_tpu_torch.ops import lie
    from goslam_tpu_torch.tracking.video import VideoBuffer
    c2w = scene.orbit_poses(n, 0.3, np.radians(3.75), 0.8, 0.2)
    intr = scene.loader_intrinsics(cfg["cam"])
    img, depth = scene.render(c2w, intr, HT, WD,
                              cfg["data"]["room_half_size"],
                              [0.1 * k for k in range(6)])
    v = VideoBuffer(cfg["tracking"]["buffer"], HT, WD, "cpu")
    v.poses[:n] = lie.from_matrix(torch.linalg.inv(c2w))
    v.disps_up[:n] = 1.0 / depth
    v.disps[:n] = v.disps_up[:n, 3::8, 3::8]
    v.images[:n] = img
    v.intrinsics.copy_(torch.tensor(intr, dtype=torch.float32) / 8)
    v.counter = n
    return v


def test_a_map_step_on_filtered_tracked_depth_matches_the_reference(nets):
    """(c) The multiview filter publishes the tracked disparities; the
    mapper draws 256 rays from them, every ray of a keyframe with a
    target depth, and takes one step at 48 + 24 samples."""
    from goslam_tpu_torch.mapping.mapper import Mapper
    from goslam_tpu_torch.tracking.multiview_filter import MultiviewFilter
    _, ref = nets
    cfg = _mono_cfg()
    v = _mapping_video(cfg)
    assert MultiviewFilter(v, cfg, warmup=cfg["tracking"]["warmup"])()
    assert float(v.mask_filtered[:v.counter].mean()) > 0.5
    m = Mapper(v, cfg)
    assert (m.n_samples, m.n_surface) == (48, 24)
    batch = m._sample_rays(list(range(4)), 64)
    depth = batch[3]
    assert depth.shape == (256,) and bool((depth > 0).all())
    bound = torch.as_tensor(v.bound, dtype=torch.float32)

    def run():
        m._optimize(batch, bound, bound, 1)

    got = _compare(run, ref)
    assert got["map_step"] <= MAP_TOL, got


@pytest.mark.parametrize("fault", ["bf16", "sensor_term"])
def test_the_control_fails(nets, fault):
    """The frontend step of (a) run in bf16, or with a sensor term where
    a mono frame has none (the port's frames get their own disparities
    as sensor disparities; the reference keeps the frame mono): each
    fails the tolerance that holds the fp32 mono step."""
    net, ref = nets
    v = _video()
    edit = None
    if fault == "bf16":
        g = _frontend_graph(net, v, torch.bfloat16)
    else:
        g = _frontend_graph(net, v)
        v.disps_sens[:N_KF] = v.disps[:N_KF]

        def edit(kind, start):
            start["video"]["disps_sens"] = torch.zeros_like(
                start["video"]["disps_sens"])

    got = _compare(_update_steps(g), ref, edit_start=edit)
    if fault == "bf16":
        assert got["update"] > UPDATE_TOL, got
    else:
        assert got["dba"] > DBA_TOL, got


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# config keys each non-key entry of `assumed` stands for
ASSUMED_KEYS = {"scene": ("data.room_half_size",),
                "left out": ("make_video", "viz"),
                "intrinsics": (), "scale": ()}
# keys the YAML leaves to SLAMSystem's own defaults (system.py)
SYSTEM_DEFAULTS = {"tracking.global_ba_every": 10,
                   "mapping.mapping_every": 5}


def test_the_configuration_is_the_published_mono_yaml():
    """replica-mono.json's config equals configs/Replica/replica_mono.yaml
    merged over replica.yaml (and go_slam.yaml's defaults) in every key
    but those its `assumed` names; nothing is reduced."""
    from goslam_tpu_torch.config import load_config
    with open(MONO_JSON) as f:
        doc = json.load(f)
    assert doc["reduced"] == []
    yaml = _flat(load_config(os.path.join(
        ROOT, "configs", "Replica", "replica_mono.yaml")))
    ours = _flat(doc["config"])
    free = set()
    for k in doc["assumed"]:
        free.update(ASSUMED_KEYS.get(k, (k,)))
    for k in free:
        assert k in ours or k in ASSUMED_KEYS, k
    for k in sorted(set(yaml) | set(ours)):
        if k in free:
            continue
        if k not in yaml:
            assert ours[k] == SYSTEM_DEFAULTS[k], k
            continue
        assert k in ours, k
        assert ours[k] == yaml[k], (k, ours[k], yaml[k])
    # the published mono settings themselves
    assert ours["mode"] == "mono"
    assert (ours["tracking.buffer"], ours["tracking.warmup"]) == (256, 8)
    assert (ours["tracking.frontend.window"],
            ours["tracking.frontend.max_factors"],
            ours["tracking.backend.loop_window"]) == (50, 100, 50)
    assert (ours["rendering.N_samples"],
            ours["rendering.N_surface"]) == (48, 24)


# the whole cell at 64x96: a filter threshold that admits keyframes at
# that size and a keyframe test that keeps them (a frame moves a fraction
# of a pixel at 1/8 of 64x96), global BA and a mapping round at every
# keyframe after the warm-up, 256 rays a map step; and the scan tracked
# on from set-up's own system (its first 9 frames and the warm-up's 16
# update steps in set-up), so that the window's first keyframe already
# runs every step the scan traffic names, however busy the machine
CELL_OVERRIDES = {"cam": {"H_out": HT, "W_out": WD},
                  "tracking": {"motion_filter": {"thresh": 0.5},
                               "frontend": {"keyframe_thresh": 0.0},
                               "global_ba_every": 1},
                  "mapping": {"pixels": 256, "iters": 1,
                              "mapping_window_size": 4,
                              "mapping_every": 1}}
CELL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
import run
from harness import cells
spec = cells.find(cells.load_benchmark(), "replica-mono.scan")
spec["traffic"] = dict(spec["traffic"], replay=False, warmup_frames=9)
res = run.run_cell(spec, 2 ** 31 + 77, {seconds}, False, device="cpu",
                   overrides={overrides!r}, control=True)
print(json.dumps({{k: res[k] for k in ("correct", "numbers", "control",
                                       "attempted", "failed")}}))
"""


def test_a_whole_mono_scan_run_is_correct_and_its_control_fails(tmp_path):
    """replica-mono.scan through the benchmark's run_cell on the CPU, with
    the mapper on (set-up tracks the first 9 frames, the window goes on
    with the same system): correct, every number of the scan's steps
    compared (map_step among them), and the control (the reference in
    fp8 in the program's place) over a limit."""
    code = CELL.format(bench=BENCH, root=ROOT, seconds=5,
                       overrides=CELL_OVERRIDES)
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    nums = res["numbers"]
    assert set(nums) == {"motion_filter", "update", "dba", "global_ba",
                         "map_step"}, nums
    assert res["correct"], nums
    assert res["failed"] == 0 and res["attempted"] > 0
    limits = {k: n["limit"] for k, n in nums.items()}
    assert any(res["control"][k] > limits[k] for k in limits), \
        (res["control"], limits)
