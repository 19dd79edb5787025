"""The benchmark's scene and traffic against the port's synthetic room."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from harness import scene, traffic


def _port_room(n, ht, wd, orbit):
    from goslam_tpu_torch.data.synthetic import Synthetic
    return Synthetic({"cam": {"H_out": ht, "W_out": wd},
                      "data": {"n_frames": n, "room_half_size": 3.0,
                               "orbit_fraction": orbit}})


@pytest.mark.parametrize("orbit", [0.5, 1.0])
def test_render_matches_the_port_room(orbit):
    n, ht, wd = 6, 24, 32
    ds = _port_room(n, ht, wd, orbit)
    poses = scene.orbit_poses(n, 0.0, 2 * math.pi * orbit / n, 0.8, 0.2)
    np.testing.assert_allclose(poses.numpy(), np.stack(ds.poses),
                               atol=1e-6)
    intr = (0.9 * wd, 0.9 * wd, wd / 2 - 0.5, ht / 2 - 0.5)
    img, depth = scene.render(poses, intr, ht, wd, 3.0, [0.0] * 6, block=4)
    for k in range(n):
        _, ref_img, ref_depth, ref_intr, _ = ds[k]
        np.testing.assert_allclose(np.asarray(intr, np.float32), ref_intr)
        np.testing.assert_allclose(img[k].numpy(), ref_img[0], atol=2e-5)
        np.testing.assert_allclose(depth[k].numpy(), ref_depth, rtol=1e-5,
                                   atol=1e-5)


def test_right_view_is_the_rigs():
    c2w = scene.orbit_poses(3, 0.3, 0.1, 0.8, 0.2)
    right = scene.right_view(c2w)
    # the right camera's centre lies 0.1 m along the left camera's x axis
    d = right[:, :3, 3] - c2w[:, :3, 3]
    np.testing.assert_allclose(d.numpy(), 0.1 * c2w[:, :3, 0].numpy(),
                               atol=1e-6)


def test_loader_intrinsics_follow_the_loaders_formula():
    cam = {"H": 480, "W": 752, "fx": 435.2, "fy": 435.2, "cx": 367.45,
           "cy": 252.2, "H_edge": 8, "W_edge": 8, "H_out": 384,
           "W_out": 512}
    fx, fy, cx, cy = scene.loader_intrinsics(cam)
    sx, sy = 528 / 752, 400 / 480
    assert (fx, fy) == pytest.approx((435.2 * sx, 435.2 * sy))
    assert (cx, cy) == pytest.approx((367.45 * sx - 8, 252.2 * sy - 8))


def _cfg(mode="rgbd"):
    return {"mode": mode, "data": {"room_half_size": 3.0},
            "cam": {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                    "cx": 599.5, "cy": 339.5, "H_edge": 0, "W_edge": 0,
                    "H_out": 16, "W_out": 24}}


def _traffic(**kw):
    t = {"motion_frames": 5, "yaw_deg_per_frame": 3.75, "radius_m": 0.8,
         "bob_m": 0.2, "stills": 0, "still_jitter_m": 0.0,
         "still_jitter_deg": 0.0, "replay": True, "warmup_frames": 3,
         "steps": ["motion_filter"]}
    t.update(kw)
    return t


def test_same_seed_same_frames_and_seeds_differ_only_in_content():
    big = 2 ** 31 + 12345
    a = traffic.make(_traffic(), _cfg(), big, "cpu")
    b = traffic.make(_traffic(), _cfg(), big, "cpu")
    c = traffic.make(_traffic(), _cfg(), big + 1, "cpu")
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.c2w, b.c2w)
    assert a.images.shape == c.images.shape
    assert not np.array_equal(a.images, c.images)
    # the motion per frame is the traffic's, whatever the seed
    for s in (a, c):
        step = np.linalg.norm(np.diff(s.c2w[:, :3, 3], axis=0), axis=1)
        assert step.max() < 0.07


def test_stills_stay_within_their_jitter_and_are_cycled():
    t = _traffic(stills=6, still_jitter_m=0.002, still_jitter_deg=0.1,
                 replay=False)
    s = traffic.make(t, _cfg("stereo"), 7, "cpu")
    assert s.images.shape[1] == 2 and s.depths is None
    stop = s.c2w[4]
    for k in range(5, 11):
        d = np.linalg.inv(stop) @ s.c2w[k]
        assert np.linalg.norm(d[:3, 3]) <= 0.002 + 1e-6
        ang = math.degrees(math.acos(min(1.0, (np.trace(d[:3, :3]) - 1)
                                         / 2)))
        assert ang <= 0.1 + 1e-3
    feed = s.feed()
    order = [next(feed) for _ in range(20)]
    assert order[0] == (True, 0)
    assert not any(new for new, _ in order[1:])
    assert [k for _, k in order[11:17]] == [5, 6, 7, 8, 9, 10]


def test_replayed_sequences_restart_with_a_fresh_system():
    s = traffic.make(_traffic(), _cfg(), 3, "cpu")
    feed = s.feed()
    order = [next(feed) for _ in range(11)]
    assert [new for new, _ in order] == [True] + [False] * 4 + [True] \
        + [False] * 4 + [True]
    assert [k for _, k in order] == [0, 1, 2, 3, 4] * 2 + [0]


def test_a_traffic_file_with_an_unknown_key_is_refused():
    with pytest.raises(ValueError):
        traffic.check(_traffic(speed=3))
