"""The port's tracking slice as a whole against the JAX package, on the CPU.

Both packages run ``SLAMSystem`` RGB-D tracking-only over the same
12-frame ``Synthetic`` sequence at 64x96 with the in-tree checkpoint
(converted for the port by ``models.convert.load_checkpoint``), then
``terminate``: two final global BAs, trajectory fill and ATE.

Keyframe decisions must not hang on rounding, so every frame is admitted
(``motion_filter.thresh: -1``) and none is removed (``keyframe_thresh:
0``); the frontend and backend compute in fp32.  ``global_ba_every: 4``
runs the backend's dense BA during tracking too.  The motion filter and
the trajectory filler run in bf16 in both packages, whatever
``compute_dtype`` says.  The JAX package runs in a process of its own
(tests/jax_subprocess.py).
"""
import os

import numpy as np
import pytest

import jax_subprocess

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

N_FRAMES = 12
OVERRIDES = {
    "dataset": "synthetic", "mode": "rgbd", "multichip": False,
    "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96,
            "H_edge": 0, "W_edge": 0},
    "data": {"input_folder": "", "n_frames": N_FRAMES},
    "tracking": {
        "buffer": 32, "warmup": 4, "compute_dtype": "float32",
        "motion_filter": {"thresh": -1.0},
        "frontend": {"window": 6, "max_factors": 24, "enable_loop": False,
                     "keyframe_thresh": 0.0},
        "global_ba_every": 4,
    },
}


def _drive(slam, ds):
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    slam.flush()
    n_kf = slam.video.counter

    def stream():
        for i in range(len(ds)):
            yield (float(i),) + tuple(ds[i][1:])

    metrics = slam.terminate(stream())
    return n_kf, metrics


def _jax_main(out):
    """The JAX package's run, in a process of its own (jax_subprocess)."""
    from goslam_tpu.config import default_config, update_recursive
    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.system import SLAMSystem, load_pretrained

    cfg = update_recursive(default_config(), OVERRIDES)
    slam = SLAMSystem(cfg, params=load_pretrained(CKPT), output=out,
                      only_tracking=True)
    n_kf, metrics = _drive(slam, Synthetic(cfg))
    return dict(n_kf=n_kf, metrics=metrics, out=out,
                poses=np.asarray(slam.video.poses[:n_kf]))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return jax_subprocess.run("test_torch_slice",
                              str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    import torch

    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem

    torch.manual_seed(0)
    out = str(tmp_path_factory.mktemp("port"))
    cfg = update_recursive(default_config(), OVERRIDES)
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT), output=out,
                      only_tracking=True, device="cpu")
    calls = []
    dense_ba = slam.backend.dense_ba
    slam.backend.dense_ba = lambda *a, **k: calls.append(a) or dense_ba(
        *a, **k)
    n_kf, metrics = _drive(slam, Synthetic(cfg))
    return dict(n_kf=n_kf, metrics=metrics, out=out, ba_calls=calls,
                poses=slam.video.poses[:n_kf].numpy())


def test_keyframe_count_matches_jax(jax_run, port_run):
    assert port_run["n_kf"] == jax_run["n_kf"] == N_FRAMES


def test_global_ba_runs_during_tracking_and_at_the_end(port_run):
    # 12 keyframes, warmup 4, every 4th keyframe after it: kf 8 and 12,
    # then the two final passes of terminate()
    assert len(port_run["ba_calls"]) == 4


def test_keyframe_poses_match_jax(jax_run, port_run):
    """Poses after the final global BA.  Both run fp32 BA, but through
    ~100 Gauss-Newton steps with sums in another order, and the
    update operator's inputs pass through bf16 in the motion filter:
    1 cm / 0.01 in the quaternion on a trajectory of ~2 m."""
    p, jp = port_run["poses"], jax_run["poses"]
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p[:, :3], jp[:, :3], atol=1e-2)
    # q and -q are one rotation
    sign = np.sign((p[:, 3:] * jp[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(p[:, 3:] * sign, jp[:, 3:], atol=1e-2)


def test_filled_trajectory_matches_jax(jax_run, port_run):
    """est_poses.npy: c2w of every input frame after trajectory filling
    (bf16 update operator in both packages)."""
    est = np.load(os.path.join(port_run["out"], "est_poses.npy"))
    jest = np.load(os.path.join(jax_run["out"], "est_poses.npy"))
    assert est.shape == jest.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, jest, atol=2e-2)


def test_ate_matches_jax(jax_run, port_run):
    """Umeyama-aligned ATE: within 2 % of the JAX run's."""
    ate = port_run["metrics"]["ate"]
    jate = jax_run["metrics"]["ate"]
    assert ate["n_poses"] == jate["n_poses"] == N_FRAMES
    assert abs(ate["rmse"] - jate["rmse"]) < 0.02 * jate["rmse"]
    assert abs(ate["scale"] - jate["scale"]) < 0.02 * jate["scale"]
    assert os.path.exists(os.path.join(port_run["out"], "metrics_traj.txt"))
