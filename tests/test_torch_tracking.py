"""The port's host-side copies and tracking state against the JAX package.

The port keeps its own copies of the JAX package's JAX-free modules
(config, synthetic data, greedy scan, shapes, evaluation): these tests
hold each copy to its original.  The keyframe store (tracking/video.py)
is compared after the same appends, a keyframe removal, distances and a
normalization.  Inputs are made with numpy from a seed.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu import config as jconfig
from goslam_tpu.data.synthetic import Synthetic as JSynthetic
from goslam_tpu.ops import lie as jlie
from goslam_tpu.tracking.video import VideoBuffer as JVideo
from goslam_tpu.utils import evaluate as jevaluate
from goslam_tpu.utils import greedy as jgreedy
from goslam_tpu.utils import shapes as jshapes
from goslam_tpu_torch import config
from goslam_tpu_torch.data.synthetic import Synthetic
from goslam_tpu_torch.ops import lie
from goslam_tpu_torch.tracking.factor_graph import FactorGraph
from goslam_tpu_torch.tracking.video import VideoBuffer
from goslam_tpu_torch.utils import evaluate, greedy, shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_config_is_the_jax_packages():
    assert config.default_config() == jconfig.default_config()
    path = os.path.join(ROOT, "configs", "Demo", "synthetic.yaml")
    assert config.load_config(path) == jconfig.load_config(path)


@pytest.mark.parametrize("index", [0, 7])
def test_synthetic_frames_are_the_jax_packages(index):
    cfg = config.update_recursive(config.default_config(), {
        "cam": {"H_out": 32, "W_out": 48},
        "data": {"n_frames": 10, "orbit_fraction": 0.7}})
    got, expect = Synthetic(cfg)[index], JSynthetic(cfg)[index]
    assert got[0] == expect[0]
    for g, e in zip(got[1:], expect[1:]):
        np.testing.assert_array_equal(g, e)


def test_greedy_scan_and_bucket_are_the_jax_packages(rng):
    d = rng.random((9, 11)) * 20
    d[rng.random((9, 11)) < 0.2] = np.inf
    picks, jpicks = [], []
    greedy.greedy_nms_scan(d.copy(), 12.0, 1,
                           lambda i, j: picks.append((i, j)) or
                           len(picks) < 8)
    jgreedy.greedy_nms_scan(d.copy(), 12.0, 1,
                            lambda i, j: jpicks.append((i, j)) or
                            len(jpicks) < 8)
    assert picks == jpicks and len(picks) == 8
    for n in (1, 8, 9, 100, 1000, 12289):
        assert shapes.bucket(n) == jshapes.bucket(n)
    with pytest.raises(ValueError):
        shapes.bucket(10 ** 6)


def test_ate_is_the_jax_packages(rng):
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.standard_normal((20, 3)) * 0.1, 0)
    est = gt.copy()
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] + 0.02 * rng.standard_normal((20, 3))
    est[5, 0, 3] = np.nan          # non-finite poses are dropped
    got = evaluate.ate_rmse(est, gt)
    expect = jevaluate.ate_rmse(est, gt)
    assert got.keys() == expect.keys()
    for k in got:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-12)
    assert got["n_poses"] == 19


def test_video_buffer_matches_jax(rng):
    """append (sensor depth subsampled at [3::8], zeros give no prior),
    remove_keyframe (state above shifts down, the last row stays),
    distance and normalize."""
    B, ht, wd = 6, 32, 48
    jv = JVideo(buffer=B, ht=ht, wd=wd)
    tv = VideoBuffer(B, ht, wd, "cpu")
    intr = np.asarray([40.0, 40.0, 23.5, 15.5], np.float32)
    for k in range(5):
        xi = (0.05 * k * rng.standard_normal(6)).astype(np.float32)
        pose = np.array(jlie.exp(jnp.asarray(xi)))
        depth = (1.0 + rng.random((ht, wd))).astype(np.float32)
        depth[rng.random((ht, wd)) < 0.3] = 0.0
        fmap = rng.standard_normal((1, 4, 6, 128)).astype(np.float32)
        ctx = rng.standard_normal((2, 4, 6, 128)).astype(np.float32)
        gt = np.eye(4, dtype=np.float32)
        image = np.zeros((ht, wd, 3), np.float32)
        jv.append(float(k), jnp.asarray(image), jnp.asarray(pose),
                  None if k else 1.0, jnp.asarray(depth), jnp.asarray(intr),
                  jnp.asarray(fmap), jnp.asarray(ctx[0]),
                  jnp.asarray(ctx[1]), jnp.asarray(gt))
        tv.append(float(k), torch.from_numpy(pose), None if k else 1.0,
                  torch.from_numpy(depth), torch.from_numpy(intr),
                  torch.from_numpy(fmap).to(torch.bfloat16),
                  torch.from_numpy(ctx[0]).to(torch.bfloat16),
                  torch.from_numpy(ctx[1]).to(torch.bfloat16),
                  torch.from_numpy(gt))
    jv.remove_keyframe(2)
    tv.remove_keyframe(2)
    assert tv.counter == jv.counter == 4
    for name in ("timestamp", "poses", "disps", "disps_sens", "fmaps",
                 "nets", "inps", "poses_gt", "damping"):
        np.testing.assert_array_equal(
            getattr(tv, name).float().numpy(),
            np.asarray(getattr(jv, name).astype(jnp.float32)), name)

    ii, jj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    np.testing.assert_allclose(tv.distance(ii, jj, beta=0.7),
                               jv.distance(ii, jj, beta=0.7), rtol=1e-5,
                               atol=1e-5)
    jv.normalize()
    tv.normalize()
    np.testing.assert_allclose(tv.disps.numpy(), np.asarray(jv.disps),
                               rtol=1e-6)
    np.testing.assert_allclose(tv.poses.numpy(), np.asarray(jv.poses),
                               rtol=1e-6, atol=1e-7)


def test_window_base_clamps_like_dynamic_slice():
    """lax.dynamic_slice clamps its start so the window fits the buffer;
    the port clamps explicitly (torch would slice short)."""
    graph = FactorGraph(VideoBuffer(32, 64, 96, "cpu"), net=None,
                        max_factors=8, corr_impl="alt")
    assert graph._window_base(5, 16) == 5
    assert graph._window_base(20, 16) == 16
    assert graph._window_base(-3, 16) == 0
    assert lie.identity((2,)).shape == (2, 7)
