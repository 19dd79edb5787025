"""Weights, the command line and the submission file of the port, against
the JAX package, on the CPU.

  * A DROID-SLAM ``droid.pth`` as ``tracking.pretrained``: a state dict
    in the reference's naming (``module.fnet.layer1.0.conv1.weight``,
    ...) made here from ``checkpoints/droid_synthetic.ckpt`` with the
    inverse of the JAX package's naming map, heads of three output
    channels and an entry neither package uses.  The JAX package's
    ``load_pretrained`` and the port's ``load_checkpoint`` read the same
    parameters from it, the checkpoint's own, and a ``SLAMSystem`` built
    with it holds them.
  * ``write_tum_trajectory`` writes the JAX package's bytes.
  * ``python -m goslam_tpu_torch.run --mode mono`` over an ETH3D folder
    without ground truth (the benchmark's test split), written from the
    synthetic room, with ``--input_folder``, ``--stride``,
    ``--calibration_txt`` and ``--max_frames``: it writes submission.txt
    at the images' own timestamps, and config.yaml that load_config
    reads back.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")

pytestmark = pytest.mark.skipif(not os.path.exists(CKPT),
                                reason="no checkpoint")

# flax module -> the reference's torch module, the inverse of the JAX
# package's models/convert.py tables
_ENC = {"conv1": "conv1", "conv2": "conv2",
        **{f"layer{s}_{b}": f"layer{s}.{b}" for s in (1, 2, 3)
           for b in (0, 1)}}
_BLOCK = {"conv1": "conv1", "conv2": "conv2", "downsample": "downsample.0"}
_UPDATE = {"corr_enc1": "corr_encoder.0", "corr_enc2": "corr_encoder.2",
           "flow_enc1": "flow_encoder.0", "flow_enc2": "flow_encoder.2",
           "weight1": "weight.0", "weight2": "weight.2",
           "delta1": "delta.0", "delta2": "delta.2"}
_AGG = {"conv1": "conv1", "conv2": "conv2", "eta": "eta", "upmask": "upmask"}


def _reference_state_dict(params):
    """The flax DroidNet tree -> a droid.pth state dict (module.-prefixed
    names, OIHW kernels)."""
    sd = {}

    def conv(name, leaf):
        k = np.asarray(leaf["kernel"], np.float32)
        sd[f"module.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"module.{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())

    for enc in ("fnet", "cnet"):
        for fname, tname in _ENC.items():
            node = params[enc][fname]
            if "kernel" in node:
                conv(f"{enc}.{tname}", node)
            else:
                for sub, tsub in _BLOCK.items():
                    if sub in node:
                        conv(f"{enc}.{tname}.{tsub}", node[sub])
    upd = params["update"]
    for fname, tname in _UPDATE.items():
        conv(f"update.{tname}", upd[fname])
    for sub, leaf in upd["gru"].items():
        conv(f"update.gru.{sub}", leaf)
    for sub, tsub in _AGG.items():
        conv(f"update.agg.{tsub}" + (".0" if sub in ("eta", "upmask")
                                     else ""), upd["agg"][sub])
    return sd


@pytest.fixture(scope="module")
def droid_pth(tmp_path_factory):
    """droid.pth from the in-tree checkpoint: the delta and weight heads
    get a third output channel (the reference cuts them to two), and an
    entry neither package reads rides along."""
    from goslam_tpu.system import load_pretrained
    sd = _reference_state_dict(load_pretrained(CKPT))
    gen = torch.Generator().manual_seed(0)
    for head in ("delta.2", "weight.2"):
        w = sd[f"module.update.{head}.weight"]
        b = sd[f"module.update.{head}.bias"]
        sd[f"module.update.{head}.weight"] = torch.cat(
            [w, torch.randn((1,) + w.shape[1:], generator=gen)])
        sd[f"module.update.{head}.bias"] = torch.cat(
            [b, torch.randn(1, generator=gen)])
    sd["module.update.unused.weight"] = torch.zeros(3)
    path = str(tmp_path_factory.mktemp("pth") / "droid.pth")
    torch.save(sd, path)
    return path


def test_droid_pth_loads_the_jax_packages_parameters(droid_pth):
    from goslam_tpu.system import load_pretrained
    from goslam_tpu_torch.models.convert import (flax_to_state_dict,
                                                 load_checkpoint)
    got = load_checkpoint(droid_pth)
    want = flax_to_state_dict(load_pretrained(droid_pth))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and they are the checkpoint's own
    own = load_checkpoint(CKPT)
    for k in own:
        assert torch.equal(got[k], own[k]), k


def test_slam_system_builds_from_a_droid_pth(droid_pth, tmp_path):
    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem
    cfg = update_recursive(default_config(), {
        "dataset": "synthetic", "mode": "mono", "only_tracking": True,
        "cam": {"H_out": 64, "W_out": 96},
        "tracking": {"buffer": 8, "pretrained": droid_pth,
                     "weight_calib": 2.0}})
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    own = load_checkpoint(CKPT)
    sd = slam.net.state_dict()
    for k in own:
        if k != "weight_calib":
            assert torch.equal(sd[k], own[k]), k
    assert float(sd["weight_calib"]) == 2.0


def test_write_tum_trajectory_is_the_jax_packages(tmp_path):
    from goslam_tpu.utils.evaluate import write_tum_trajectory as jax_write
    from goslam_tpu_torch.ops import lie
    from goslam_tpu_torch.utils.evaluate import write_tum_trajectory
    rng = np.random.default_rng(3)
    c2w = lie.matrix(lie.exp(torch.as_tensor(
        rng.standard_normal((9, 6)), dtype=torch.float32))).numpy()
    ts = 1403636579.763555 + np.cumsum(rng.random(9))
    write_tum_trajectory(str(tmp_path / "port.txt"), ts, c2w)
    jax_write(str(tmp_path / "jax.txt"), ts, c2w)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert len((tmp_path / "port.txt").read_text().splitlines()) == 9


def _write_eth3d_test_split(root, n, ht, wd):
    """The synthetic room as an ETH3D sequence without groundtruth.txt:
    rgb/ and depth/ PNGs (depth at png_depth_scale 5000) listed in
    rgb.txt and depth.txt at timestamps of their own.  Returns the
    timestamps and the intrinsics (fx fy cx cy)."""
    import cv2

    from goslam_tpu_torch.config import default_config, update_recursive
    from goslam_tpu_torch.data.synthetic import Synthetic
    ds = Synthetic(update_recursive(default_config(), {
        "cam": {"H_out": ht, "W_out": wd}, "data": {"n_frames": n}}))
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    ts = 1616161616.123456 + 0.1 * np.arange(n)
    with open(os.path.join(root, "rgb.txt"), "w") as fr, \
            open(os.path.join(root, "depth.txt"), "w") as fd:
        for i in range(n):
            _, img, depth, intr, _ = ds[i]
            name = f"{ts[i]:.6f}.png"
            bgr = np.round(img[0][..., ::-1] * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(root, "rgb", name), bgr)
            cv2.imwrite(os.path.join(root, "depth", name),
                        np.round(depth * 5000).astype(np.uint16))
            fr.write(f"{ts[i]:.6f} rgb/{name}\n")
            fd.write(f"{ts[i]:.6f} depth/{name}\n")
    return ts, intr


def test_run_mono_on_an_eth3d_test_split(tmp_path):
    """The CLI over an ETH3D folder without ground truth, in mono: no
    ATE, submission.txt at the images' timestamps (%.9f), config.yaml
    with the command line's settings, the package's source in
    code_backup/."""
    from goslam_tpu_torch.config import load_config
    pytest.importorskip("cv2")
    data = str(tmp_path / "sofa")
    ts, intr = _write_eth3d_test_split(data, 16, 128, 192)
    calib = tmp_path / "calibration.txt"
    calib.write_text(" ".join(f"{x:.6f}" for x in intr) + "\n")
    # the ETH3D settings, cut for the CPU: the synthetic frames' size,
    # no border, the in-tree checkpoint, a short warm-up, the admission
    # threshold of a 64x96 image's flow
    cfg = tmp_path / "cut.yaml"
    cfg.write_text(
        f"inherit_from: {os.path.join(ROOT, 'configs', 'ETH3D', 'eth3d.yaml')}\n"
        "cam: {H: 128, W: 192, H_edge: 0, W_edge: 0}\n"
        f"tracking: {{pretrained: {CKPT}, buffer: 32, warmup: 4,\n"
        "  motion_filter: {thresh: 1.0},\n"
        "  frontend: {window: 6, max_factors: 24, enable_loop: False}}\n")
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "goslam_tpu_torch.run", str(cfg),
         "--mode", "mono", "--only_tracking", "--device", "cpu",
         "--image_size", "64", "96", "--input_folder", data,
         "--stride", "2", "--calibration_txt", str(calib),
         "--max_frames", "12", "--output", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    # the frontend ran: more keyframes than its warm-up
    kf = int(res.stdout.split(" keyframes")[0].rsplit(" ", 1)[-1])
    assert kf > 4, res.stdout
    assert not (out / "metrics_traj.txt").exists()
    lines = (out / "submission.txt").read_text().splitlines()
    # rgb.txt holds them at 6 decimals
    assert [l.split()[0] for l in lines] == \
        [f"{float(f'{t:.6f}'):.9f}" for t in ts[:12]]
    vals = np.asarray([[float(x) for x in l.split()[1:]] for l in lines])
    assert vals.shape == (12, 7) and np.isfinite(vals).all()
    np.testing.assert_allclose(np.linalg.norm(vals[:, 3:], axis=1), 1,
                               atol=1e-6)
    saved = load_config(str(out / "config.yaml"))
    assert saved["mode"] == "mono" and saved["dataset"] == "eth3d"
    assert saved["stride"] == 2 and saved["data"]["max_frames"] == 12
    assert saved["data"]["input_folder"] == data
    assert (saved["cam"]["H_out"], saved["cam"]["W_out"]) == (64, 96)
    np.testing.assert_allclose(
        [saved["cam"][k] for k in ("fx", "fy", "cx", "cy")], intr,
        atol=1e-6)
    assert (out / "code_backup" / "goslam_tpu_torch" / "run.py").exists()
    assert (out / "est_poses.npy").exists() and (out / "go.ckpt").exists()
