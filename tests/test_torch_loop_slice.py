"""Loop closing as a whole, in the port and in the JAX package, on the CPU.

Both run ``SLAMSystem`` RGB-D tracking-only with
``tracking.frontend.enable_loop: True`` over the same 16-frame
``Synthetic`` sequence at 64x96.  From the seventh keyframe on, every
frontend update ends in ``Backend.loop_ba``: the frontend's live
edges are copied into a fresh graph, loop candidates of the last
``loop_window`` keyframes pass the neighbourhood vote or not, and two
low-memory steps (alt-corr, chunked GRU, DBA) run over all keyframes.

As in tests/test_torch_slice.py every frame is admitted and none removed,
and the frontend and backend compute in fp32.  No periodic global BA and
no ``terminate``: what is compared is the state loop closing leaves.  The
loop window and threshold are cut to the sequence (8 keyframes, 12 px at
1/8 resolution).

The camera turns 6 degrees per frame (96 degrees in all).  A full orbit in
as few frames tracks so badly at this size that a rounding difference
flips a greedy edge choice and the two runs part by decimetres; at 6
degrees the port agrees with itself to 1e-4 whatever its number of
threads, so the comparison is one of the two packages, not of luck.
The JAX package runs in a process of its own (tests/jax_subprocess.py).
"""
import os

import numpy as np
import pytest

import jax_subprocess

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

N_FRAMES = 16
WINDOW = 6
OVERRIDES = {
    "dataset": "synthetic", "mode": "rgbd", "multichip": False,
    "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96,
            "H_edge": 0, "W_edge": 0},
    "data": {"input_folder": "", "n_frames": N_FRAMES,
             "orbit_fraction": 16 / 60},
    "tracking": {
        "buffer": 48, "warmup": 4, "compute_dtype": "float32",
        "motion_filter": {"thresh": -1.0},
        "frontend": {"window": WINDOW, "max_factors": 24,
                     "enable_loop": True, "keyframe_thresh": 0.0},
        "backend": {"loop_window": 8, "loop_thresh": 12.0,
                    "loop_radius": 1, "loop_nms": 1},
        "global_ba_every": 0,
    },
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several workers on one machine; PyTorch's default of
    one thread per core in each of them makes them all wait on each
    other.  Two threads per worker for this file, restored after it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _drive(slam, ds):
    """Track every frame; returns the loop_ba calls as (t_end, candidates
    accepted, edges optimized)."""
    calls = []
    loop_ba = slam.backend.loop_ba

    def spy(*a, **k):
        _, n_edges = loop_ba(*a, **k)
        calls.append((k["t_end"], slam.backend.last_loop_accepts, n_edges))
        return _, n_edges

    slam.backend.loop_ba = spy
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    slam.flush()
    return calls


def _jax_main(out):
    """The JAX package's run, in a process of its own (jax_subprocess)."""
    from goslam_tpu.config import default_config, update_recursive
    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.system import SLAMSystem, load_pretrained

    cfg = update_recursive(default_config(), OVERRIDES)
    slam = SLAMSystem(cfg, params=load_pretrained(CKPT), output=out,
                      only_tracking=True)
    calls = _drive(slam, Synthetic(cfg))
    n_kf = slam.video.counter
    return dict(n_kf=n_kf, calls=calls,
                accepts=slam.backend.total_loop_accepts,
                last_loop_t=slam.frontend.last_loop_t,
                poses=np.asarray(slam.video.poses[:n_kf]),
                disps=np.asarray(slam.video.disps[:n_kf]))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return jax_subprocess.run("test_torch_loop_slice",
                              str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    import torch

    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem

    torch.manual_seed(0)
    cfg = update_recursive(default_config(), OVERRIDES)
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT),
                      output=str(tmp_path_factory.mktemp("port")),
                      only_tracking=True, device="cpu")
    assert slam.frontend.loop_closing is slam.backend
    calls = _drive(slam, Synthetic(cfg))
    n_kf = slam.video.counter
    return dict(n_kf=n_kf, calls=calls,
                accepts=slam.backend.total_loop_accepts,
                last_loop_t=slam.frontend.last_loop_t,
                poses=slam.video.poses[:n_kf].numpy(),
                disps=slam.video.disps[:n_kf].numpy())


def test_loop_slice_keyframes_and_loop_ba_calls_match_jax(jax_run, port_run):
    assert port_run["n_kf"] == jax_run["n_kf"] == N_FRAMES
    # warmup 4, then one frontend update per keyframe; loop_ba replaces
    # the last two update steps once more than `window` keyframes exist
    assert [c[0] for c in port_run["calls"]] == \
        list(range(WINDOW + 1, N_FRAMES + 1))
    assert len(port_run["calls"]) == len(jax_run["calls"])
    assert port_run["last_loop_t"] == jax_run["last_loop_t"] == N_FRAMES


def test_loop_slice_accepts_the_same_loop_candidates(jax_run, port_run):
    """Call by call: the same number of candidates pass the vote and the
    same number of edges is optimized; some candidates do pass."""
    assert port_run["calls"] == jax_run["calls"]
    assert port_run["accepts"] == jax_run["accepts"] > 0
    assert all(c[1] > 0 for c in port_run["calls"])


def test_loop_slice_poses_match_jax(jax_run, port_run):
    """Keyframe poses and disparities after the last loop_ba.  Both run
    fp32 BA, but through ~80 Gauss-Newton steps with sums in another
    order, and the features pass through bf16 in the motion filter: the
    slice test's 1 cm / 0.01 in the quaternion, on a trajectory that
    spans ~2 m."""
    p, jp = port_run["poses"], jax_run["poses"]
    assert np.isfinite(p).all() and np.isfinite(port_run["disps"]).all()
    assert np.ptp(jp[:, :3], axis=0).max() > 1.0
    np.testing.assert_allclose(p[:, :3], jp[:, :3], atol=1e-2)
    sign = np.sign((p[:, 3:] * jp[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(p[:, 3:] * sign, jp[:, 3:], atol=1e-2)
    np.testing.assert_allclose(port_run["disps"], jax_run["disps"],
                               rtol=2e-2, atol=2e-3)
