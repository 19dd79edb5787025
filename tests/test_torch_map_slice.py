"""The port's mapping slice as a whole against the JAX package, on the CPU.

Both packages run ``SLAMSystem`` with mapping on over tests/test_system.py's
``demo_cfg`` (the synthetic room at 64x96, every frame a keyframe, the
multiview filter and a mapper round every 4 keyframes, one final round,
meshing at resolution 64) with the in-tree checkpoint, then
``terminate`` with the room's GT mesh.  Tracking is
tests/test_torch_slice.py's (12 frames, fp32 frontend, upsampled
disparities, global BA every 4 keyframes).  With demo_cfg's own
tracking the two packages' filled trajectories sit centimetres apart:
their frontends agree given the same bf16 keyframe features, and the
chaos is in ``terminate``, where the JAX package's own trajectory moves
by 6.8 cm between two processes (tests/test_torch_demo_tracking.py).  The
JAX package runs in a process of its own (tests/jax_subprocess.py).
Mesh evaluation samples 20,000 points.

The mapper's device draws differ between the packages, so the trained
maps do too.  The RNG-free end-to-end parity: the JAX run's trained
parameters and filtered state, converted, go through the port's
``extract_final_mesh`` and give the JAX run's meshes and mesh metrics.
A ``go.ckpt`` written by the JAX package resumes tracking in the port;
the port's own checkpoint round-trips.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax_subprocess
from test_system import demo_cfg
from test_torch_slice import OVERRIDES as TRACKING

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

N = TRACKING["data"]["n_frames"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once, and
    more threads than cores slow torch's small operations many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

OVERRIDES = {"multichip": False, "tracking": {"upsample": True},
             "meshing": {"eval_rec": True, "n_points_to_eval": 20000}}


def _cfg(out):
    from goslam_tpu_torch.config import update_recursive
    cfg = update_recursive(demo_cfg(), copy.deepcopy(TRACKING))
    return update_recursive(cfg, dict(OVERRIDES, data={"output": out}))


class _Rounds:
    """The system's mapper, with its rounds counted."""

    def __init__(self, mapper):
        self.mapper, self.rounds = mapper, []

    def __call__(self, the_end=False):
        self.rounds.append(the_end)
        return self.mapper(the_end=the_end)

    def __getattr__(self, name):
        return getattr(self.mapper, name)


def _drive(slam, ds, out):
    from goslam_tpu_torch.mapping import mesher
    slam.mapper = _Rounds(slam.mapper)
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    slam.flush()
    gt_path = os.path.join(out, "gt_mesh.ply")
    mesher.save_ply(gt_path, *ds.gt_mesh())

    def stream():
        for i in range(len(ds)):
            yield (float(i),) + tuple(ds[i][1:])

    metrics = slam.terminate(stream(), eval_mesh_path=gt_path)
    rounds = slam.mapper.rounds
    slam.mapper = slam.mapper.mapper
    return metrics, rounds, gt_path


def _jax_main(out):
    """The JAX package's run, in a process of its own
    (jax_subprocess)."""
    import jax

    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.system import SLAMSystem, load_pretrained

    cfg = _cfg(out)
    slam = SLAMSystem(cfg, params=load_pretrained(CKPT), output=out)
    metrics, rounds, gt_path = _drive(slam, Synthetic(cfg), out)
    v, n = slam.video, slam.video.counter
    return dict(
        out=out, metrics=metrics, rounds=rounds, gt_path=gt_path, n=n,
        poses=np.asarray(v.poses[:n]), masks=np.asarray(v.mask_filtered[:n]),
        bound=v.bound.copy(), filtered_id=v.filtered_id,
        intrinsics=np.asarray(v.intrinsics),
        params=jax.tree.map(np.asarray, slam.mapper.params),
        **{k: np.asarray(getattr(v, k)[:n]) for k in (
            "disps_filtered", "mask_filtered", "poses_filtered")})


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return jax_subprocess.run("test_torch_map_slice",
                              str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem

    torch.manual_seed(0)
    out = str(tmp_path_factory.mktemp("port"))
    cfg = _cfg(out)
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT), output=out,
                      device="cpu")
    ds = Synthetic(cfg)
    metrics, rounds, _ = _drive(slam, ds, out)
    v, n = slam.video, slam.video.counter
    return dict(slam=slam, out=out, metrics=metrics, rounds=rounds, n=n,
                poses=v.poses[:n].numpy(),
                masks=v.mask_filtered[:n].numpy(), bound=v.bound.copy(),
                filtered_id=v.filtered_id)


def test_outputs_of_the_mapping_path(port_run):
    """terminate writes the trajectory, its ATE, the checkpoint, the
    meshes and their metrics; everything is finite."""
    out = port_run["out"]
    for f in ("est_poses.npy", "metrics_traj.txt", "go.ckpt",
              "metrics_mesh.txt", "mesh/final_raw.ply", "mesh/cull_mesh.ply",
              "mesh/forecast_mesh.ply"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "metrics_mesh.txt")) as f:
        mesh = json.load(f)
    assert mesh == port_run["metrics"]["mesh"]
    assert all(np.isfinite(v) for v in mesh.values())
    assert np.load(os.path.join(out, "est_poses.npy")).shape == (N, 4, 4)


def test_keyframe_poses_match_jax(jax_run, port_run):
    """As tests/test_torch_slice.py holds them, after the final global
    BA: 1 cm and 0.01 in the quaternion (the port's poses with mapping
    on are its poses without it, bit for bit)."""
    p, jp = port_run["poses"], jax_run["poses"]
    assert port_run["n"] == jax_run["n"] == N
    np.testing.assert_allclose(p[:, :3], jp[:, :3], atol=1e-2)
    sign = np.sign((p[:, 3:] * jp[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(p[:, 3:] * sign, jp[:, 3:], atol=1e-2)


def test_filter_outputs_and_mapper_rounds_match_jax(jax_run, port_run):
    """The same mapper rounds (two while tracking, one final), the same
    keyframes published; the masks, from poses up to 1 cm apart, agree
    on 97 % of the pixels and the bounds within 5 cm (the filter on the
    same poses: tests/test_torch_mesher.py, exactly)."""
    assert port_run["rounds"] == jax_run["rounds"] == [False, False, True]
    assert port_run["filtered_id"] == jax_run["filtered_id"] == N
    agree = (port_run["masks"] == jax_run["masks"]).mean()
    assert agree >= 0.97, agree
    np.testing.assert_allclose(port_run["bound"], jax_run["bound"],
                               atol=0.05)


def _jax_trajectory(jax_run):
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.utils import evaluate
    est = np.load(os.path.join(jax_run["out"], "est_poses.npy"))
    ds = Synthetic(_cfg(""))
    gt = np.stack([ds[i][4] for i in range(len(ds))])
    return est, evaluate.ate_rmse(est, gt, correct_scale=True)["alignment"]


def test_jax_map_through_the_port_mesher_gives_jax_mesh(jax_run, port_run,
                                                        tmp_path):
    """The JAX run's trained map (converted) and filtered state, its
    trajectory and ATE alignment, through the port's extract_final_mesh:
    the raw mesh's vertex count within 0.5 % of the JAX run's
    final_raw.ply; accuracy and completion within 1e-3 of its
    metrics_mesh.txt, relative; the ratios and the F-score, which count
    sampled points within 5 cm, within 5 of the 20,000 points
    (0.025 percentage points)."""
    from goslam_tpu_torch.mapping import mesher
    from goslam_tpu_torch.models.convert import convert_mapping_params
    slam, n = port_run["slam"], jax_run["n"]
    v = slam.video
    v.counter = n
    v.bound = jax_run["bound"].copy()
    v.intrinsics[:] = torch.from_numpy(jax_run["intrinsics"])
    for name in ("disps_filtered", "mask_filtered", "poses_filtered"):
        getattr(v, name)[:n] = torch.from_numpy(jax_run[name])
    slam.mapper.model.load_state_dict(convert_mapping_params(
        jax_run["params"]))
    slam.output = str(tmp_path)
    est, align = _jax_trajectory(jax_run)
    res = slam.extract_final_mesh(jax_run["gt_path"], est_c2w_list=est,
                                  trans_init=align)

    got, _ = mesher.load_ply(str(tmp_path / "mesh" / "final_raw.ply"))
    expect, _ = mesher.load_ply(os.path.join(jax_run["out"], "mesh",
                                             "final_raw.ply"))
    assert abs(len(got) - len(expect)) <= 0.005 * len(expect)
    with open(os.path.join(jax_run["out"], "metrics_mesh.txt")) as f:
        jmesh = json.load(f)
    assert res.keys() == jmesh.keys()
    for k in res:
        tol = 1e-3 * abs(jmesh[k]) if k.endswith("_cm") else 0.025
        assert abs(res[k] - jmesh[k]) <= tol, (k, res[k], jmesh[k])


def test_jax_checkpoint_resumes_tracking_in_the_port(jax_run, tmp_path):
    """The JAX run's go.ckpt (flax trees, bf16 features) loads into a new
    port system: keyframes, map and tracking state; both packages then
    track two more frames of the same orbit from it, to poses within
    1 cm of each other."""
    from goslam_tpu.data.synthetic import Synthetic as JSynthetic
    from goslam_tpu.system import SLAMSystem as JSLAMSystem
    from goslam_tpu.system import load_pretrained
    from goslam_tpu_torch.config import update_recursive
    from goslam_tpu_torch.models.convert import (convert_mapping_params,
                                                 load_checkpoint)
    from goslam_tpu_torch.system import SLAMSystem

    ckpt = os.path.join(jax_run["out"], "go.ckpt")
    cfg = _cfg(str(tmp_path))
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT),
                      output=str(tmp_path), device="cpu")
    state = slam.load_checkpoint(ckpt)
    n = jax_run["n"]
    assert slam.video.counter == state["counter"] == n
    np.testing.assert_array_equal(slam.video.poses[:n].numpy(),
                                  jax_run["poses"])
    # the map as terminate saved it, before the final rounds
    for k, p in convert_mapping_params(state["mapping_params"]).items():
        np.testing.assert_array_equal(slam.mapper.model.state_dict()[k], p)
    assert slam.frontend.is_initialized and slam.frontend.t1 == n

    # the same orbit, two frames longer
    longer = update_recursive(cfg, {"data": {
        "n_frames": N + 2, "orbit_fraction": cfg["data"].get(
            "orbit_fraction", 0.5) * (N + 2) / N}})
    jslam = JSLAMSystem(longer, params=load_pretrained(CKPT),
                        output=str(tmp_path / "jax"))
    jslam.load_checkpoint(ckpt)
    ds = JSynthetic(longer)
    for i in (N, N + 1):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
        jslam.track(float(i), img, depth, intr, gt)
    jslam.flush()
    assert slam.video.counter == jslam.video.counter == n + 2
    p = slam.video.poses[:n + 2].numpy()
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p[:, :3], np.asarray(jslam.video.poses[:n + 2])
                               [:, :3], atol=1e-2)


def test_port_checkpoint_round_trips(port_run, tmp_path):
    """save_checkpoint -> load_checkpoint into a new system: keyframes,
    images, features, the map, the motion filter and the frontend."""
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    a = port_run["slam"]
    path = str(tmp_path / "ck.pkl")
    a.save_checkpoint(path)
    b = SLAMSystem(_cfg(str(tmp_path)), state_dict=load_checkpoint(CKPT),
                   output=str(tmp_path), device="cpu")
    b.load_checkpoint(path)
    n = a.video.counter
    assert b.video.counter == n
    for name in ("poses", "disps", "timestamp", "images", "disps_sens",
                 "fmaps", "nets", "inps", "poses_gt", "intrinsics"):
        x, y = getattr(a.video, name), getattr(b.video, name)
        if name != "intrinsics":
            x, y = x[:n], y[:n]
        torch.testing.assert_close(y, x, rtol=0, atol=0.5 / 255
                                   if name == "images" else 0)
    for k, p in a.mapper.model.state_dict().items():
        assert torch.equal(b.mapper.model.state_dict()[k], p), k
    assert torch.equal(b.motion_filter.fmap, a.video.fmaps[n - 1].float())
    assert b.frontend.is_initialized and b.frontend.t1 == n
    with pytest.raises(ValueError, match="full tracking fields"):
        a.save_checkpoint(path, full=False)
        b.load_checkpoint(path)
