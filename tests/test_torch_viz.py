"""The headless live viewer and the mesh video, on the CPU.

``LiveViewer`` against the JAX package's on the same keyframe store (its
points, masks and cameras, and the dirty bits it clears), the mesh-video
tool on a run directory, and a ``make_video`` + ``viz`` run of
``SLAMSystem``: one mesh per mapping round, and the viewer's point cloud
and cameras written at the end.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

HT, WD, N, BUF = 32, 48, 9, 12
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "droid_synthetic.ckpt")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _store(full: bool) -> dict:
    """A keyframe store made with numpy from a seed: a camera moving
    along x in front of a plane 2 m away (neighbouring frames agree on
    most pixels), disparities with 1 % noise, images; with `full` the
    upsampled disparities too, which the viewer then takes."""
    from goslam_tpu.ops import lie as jlie
    rng = np.random.default_rng(3 + full)
    h8, w8 = HT // 8, WD // 8
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = -0.05 * np.arange(N)
    xi[:, 3:] = 0.01 * rng.standard_normal((N, 3))
    poses = np.asarray(jlie.exp(jnp.asarray(xi)))
    disps = (0.5 * (1 + 0.01 * rng.standard_normal((N, h8, w8)))).astype(
        np.float32)
    up = (0.5 * (1 + 0.01 * rng.standard_normal((N, HT, WD)))).astype(
        np.float32) if full else np.zeros((N, HT, WD), np.float32)
    dirty = np.zeros(BUF, bool)
    dirty[[0, 2, 3, 4, 7, 8]] = True
    return dict(poses=poses, disps=disps, up=up, dirty=dirty,
                images=rng.random((N, HT, WD, 3)).astype(np.float32),
                intr=np.asarray([5.0, 5.0, 2.9, 1.9], np.float32))


@pytest.mark.parametrize("full", [False, True], ids=["eighth", "full"])
def test_live_viewer_matches_jax(full, tmp_path):
    """One update of each package's viewer on the same store: the same
    keyframes consumed (their dirty bits cleared, the others kept), and
    each keyframe's kept points (the same mask), colours and camera
    within 1e-5; at 1/8 resolution and with upsampled disparities."""
    from goslam_tpu.tracking.video import VideoBuffer as JVideo
    from goslam_tpu.utils.visualization import LiveViewer as JViewer
    from goslam_tpu_torch.tracking.video import VideoBuffer
    from goslam_tpu_torch.utils.visualization import LiveViewer

    st = _store(full)
    jv = JVideo(buffer=BUF, ht=HT, wd=WD)
    jv.poses = jv.poses.at[:N].set(st["poses"])
    jv.disps = jv.disps.at[:N].set(st["disps"])
    jv.disps_up = jv.disps_up.at[:N].set(st["up"])
    jv.images = jv.images.at[:N].set(st["images"])
    jv.intrinsics = jnp.asarray(st["intr"])
    jv.counter = N
    jv.dirty = st["dirty"].copy()
    tv = VideoBuffer(BUF, HT, WD, "cpu")
    tv.poses[:N] = torch.from_numpy(np.array(st["poses"]))
    tv.disps[:N] = torch.from_numpy(st["disps"])
    tv.disps_up[:N] = torch.from_numpy(st["up"])
    tv.images[:N] = torch.from_numpy(st["images"])
    tv.intrinsics.copy_(torch.from_numpy(st["intr"]))
    tv.counter = N
    tv.dirty = st["dirty"].copy()

    jview = JViewer(jv, str(tmp_path / "jax"), filter_thresh=0.05)
    view = LiveViewer(tv, str(tmp_path / "port"), filter_thresh=0.05)
    assert view.update() == jview.update() == 6
    assert not tv.dirty.any() and not jv.dirty.any()
    assert sorted(view.points) == sorted(jview.points) == [0, 2, 3, 4, 7, 8]
    kept = 0
    for k in view.points:
        (p, c), (jp, jc) = view.points[k], jview.points[k]
        assert p.shape == jp.shape
        np.testing.assert_allclose(p, jp, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(view.cameras[k], jview.cameras[k],
                                   atol=1e-5)
        kept += len(p)
    # the filter keeps some points and drops others
    n_px = 6 * (HT * WD if full else (HT // 8) * (WD // 8))
    assert 0 < kept < n_px
    assert view.update() == 0                    # nothing dirty any more
    tv.dirty[3] = True
    assert view.update() == 1 and not tv.dirty.any()


def test_make_video_renders_every_mesh(tmp_path):
    """make_video renders every mesh/*.ply with the trajectory into an mp4
    (tests/test_mesh_culling.py's check of the JAX package's)."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    from goslam_tpu_torch.mapping.mesher import save_ply
    from goslam_tpu_torch.tools.meshvideo import make_video

    run = tmp_path / "run"
    (run / "mesh").mkdir(parents=True)
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    t = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    for k in range(2):
        save_ply(str(run / "mesh" / f"{k:05d}_mesh.ply"), v + 0.1 * k, t)
    traj = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    traj[:, 0, 3] = np.linspace(0, 1, 6)
    np.save(str(run / "est_poses.npy"), traj)

    out = make_video(str(run), fps=2)
    assert out is not None and os.path.exists(out)
    assert os.path.getsize(out) > 1000
    assert len(list((run / "video_frames").glob("*.png"))) == 2
    assert make_video(str(tmp_path)) is None     # no mesh, no video


@pytest.mark.skipif(not os.path.exists(CKPT), reason="no checkpoint")
def test_make_video_and_viewer_run(tmp_path):
    """SLAMSystem with make_video and viz on, mapping at a load cut for the
    CPU: one mesh/<timestamp>_mesh.ply per mapping round during tracking,
    each with triangles, and the viewer's point cloud and cameras written
    at the end, with points."""
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.mapping import mesher
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem

    cfg = update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "rgbd", "make_video": True,
        "viz": True, "viz_options": {"save_every": 0, "filter_thresh": 0.05},
        "cam": {"H": 64, "W": 96, "H_out": 64, "W_out": 96,
                "H_edge": 0, "W_edge": 0},
        "data": {"input_folder": "", "n_frames": 7, "output": ""},
        "tracking": {"buffer": 16, "warmup": 4, "upsample": False,
                     "motion_filter": {"thresh": -1.0},
                     "frontend": {"window": 6, "max_factors": 24,
                                  "enable_loop": False,
                                  "keyframe_thresh": 0.0},
                     "global_ba_every": 0,
                     "multiview_filter": {"thresh": 0.1}},
        "mapping": {"mapping_every": 2, "pixels": 128, "iters": 1,
                    "post_processing_iters": 1,
                    "mapping_window_size": 4},
        "rendering": {"N_samples": 8, "N_surface": 8},
        "meshing": {"resolution": 16, "eval_rec": False},
    })
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT),
                      output=str(tmp_path), device="cpu")
    rounds = []
    schedule = slam.mapper.schedule
    slam.mapper.schedule = lambda cur: rounds.append(cur) or schedule(cur)
    ds = Synthetic(cfg)
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    during = len(rounds)
    meshes = sorted(p for p in os.listdir(tmp_path / "mesh")
                    if p.endswith("_mesh.ply") and p[:5].isdigit())
    assert during >= 2 and len(meshes) == during
    for p in meshes:
        v, t = mesher.load_ply(str(tmp_path / "mesh" / p))
        assert len(t) > 0 and np.isfinite(v).all()
    slam.terminate()
    assert len(rounds) == during + 1             # the final round
    pc = [p for p in os.listdir(tmp_path / "pointcloud")
          if p.endswith("_pc.ply")]
    assert len(pc) == 1
    pts, _ = mesher.load_ply(str(tmp_path / "pointcloud" / pc[0]))
    assert len(pts) > 0 and np.isfinite(pts).all()
    with open(tmp_path / "pointcloud" / "cameras.ply") as f:
        head = f.read(200)
    assert f"element vertex {5 * slam.video.counter}" in head


def test_export_pointcloud_and_metrics_match_jax(tmp_path):
    """export_pointcloud writes the JAX package's points and colours for
    the same multiview-filtered store (strided, masked); psnr and
    depth_metrics are its numbers."""
    from goslam_tpu.tracking.video import VideoBuffer as JVideo
    from goslam_tpu.utils import visualization as jviz
    from goslam_tpu_torch.mapping.mesher import load_ply
    from goslam_tpu_torch.tracking.video import VideoBuffer
    from goslam_tpu_torch.utils import visualization as viz

    st = _store(True)
    rng = np.random.default_rng(9)
    masks = (rng.random((N, HT, WD)) < 0.5).astype(np.float32)
    jv = JVideo(buffer=BUF, ht=HT, wd=WD)
    jv.poses_filtered = jv.poses_filtered.at[:N].set(st["poses"])
    jv.disps_filtered = jv.disps_filtered.at[:N].set(st["up"])
    jv.mask_filtered = jv.mask_filtered.at[:N].set(masks)
    jv.images = jv.images.at[:N].set(st["images"])
    jv.intrinsics = jnp.asarray(st["intr"])
    jv.counter = jv.filtered_id = N
    tv = VideoBuffer(BUF, HT, WD, "cpu")
    tv.poses_filtered[:N] = torch.from_numpy(np.array(st["poses"]))
    tv.disps_filtered[:N] = torch.from_numpy(st["up"])
    tv.mask_filtered[:N] = torch.from_numpy(masks)
    tv.images[:N] = torch.from_numpy(st["images"])
    tv.intrinsics.copy_(torch.from_numpy(st["intr"]))
    tv.counter = tv.filtered_id = N

    n = viz.export_pointcloud(str(tmp_path / "port.ply"), tv, stride=2)
    jn = jviz.export_pointcloud(str(tmp_path / "jax.ply"), jv, stride=2)
    assert n == jn > 0
    got, want = (load_ply(str(tmp_path / f))[0]
                 for f in ("port.ply", "jax.ply"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with open(tmp_path / "port.ply", "rb") as f, \
            open(tmp_path / "jax.ply", "rb") as g:
        # the same header and the same colour bytes after each point
        a, b = f.read(), g.read()
    assert a[:a.index(b"end_header")] == b[:b.index(b"end_header")]
    a = np.frombuffer(a[a.index(b"end_header") + 11:][:15 * n], np.uint8)
    b = np.frombuffer(b[b.index(b"end_header") + 11:][:15 * n], np.uint8)
    np.testing.assert_array_equal(a.reshape(n, 15)[:, 12:],
                                  b.reshape(n, 15)[:, 12:])

    est, gt = st["up"][0], st["up"][1] * (rng.random((HT, WD)) > 0.2)
    assert viz.psnr(est, gt) == jviz.psnr(est, gt)
    assert viz.depth_metrics(est, gt) == jviz.depth_metrics(est, gt)
