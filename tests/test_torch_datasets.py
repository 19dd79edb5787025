"""The port's dataset loaders against the JAX package's, on files written
under tmp_path in each dataset's layout (no dataset is downloaded).

Every class of the registry gives the same items as the JAX package's,
exactly: frames (resize, BGR -> RGB, crop; EuRoC's rectified stereo
pair at 752x480), depth, intrinsics, poses and timestamps.  Also:
``save_config`` writes what the JAX package's writes, and without
OpenCV the module imports, the synthetic room reads, and a real
dataset's read raises ImportError naming OpenCV.  This OpenCV has no
EXR writer, so CoFusion is read without its depth_noise/*.exr.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(7)


def _img(path, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, RNG.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _depth(path, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, RNG.integers(500, 4000, (h, w), dtype=np.uint16))


def _pose_rows(n):
    """n c2w matrices: a small rotation about y and a translation."""
    out = []
    for k in range(n):
        a = 0.05 * k
        m = np.eye(4)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.1 * k, -0.02 * k, 0.3]
        out.append(m)
    return out


def _quat_line(m):
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(m[:3, :3]).as_quat()
    return " ".join(f"{x:.6f}" for x in (*m[:3, 3], *q))


def write_replica(root, n=5, h=48, w=64):
    for k in range(n):
        _img(f"{root}/results/frame{k:06d}.jpg", h, w)
        _depth(f"{root}/results/depth{k:06d}.png", h, w)
    with open(f"{root}/traj.txt", "w") as f:
        for m in _pose_rows(n):
            f.write(" ".join(f"{x:.8f}" for x in m.reshape(-1)) + "\n")


def write_scannet(root, n=12, h=48, w=64):
    for k in range(n):
        _img(f"{root}/frames/color/{k}.jpg", h, w)
        _depth(f"{root}/frames/depth/{k}.png", h, w)
        os.makedirs(f"{root}/frames/pose", exist_ok=True)
        np.savetxt(f"{root}/frames/pose/{k}.txt", _pose_rows(n)[k])


def write_tum(root, n=8, h=48, w=64, gt=True, dt=0.02):
    """TUM / ETH3D lists, depth 4 ms after each image, images every dt
    (at 0.02 s the 32 fps thinning of TUM drops some)."""
    with open(f"{root}/rgb.txt", "w") as fr, \
            open(f"{root}/depth.txt", "w") as fd:
        fr.write("# timestamp filename\n")
        for k in range(n):
            t = 1305031102.175304 + k * dt
            fr.write(f"{t:.6f} rgb/{t:.6f}.png\n")
            fd.write(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png\n")
            _img(f"{root}/rgb/{t:.6f}.png", h, w)
            _depth(f"{root}/depth/{t + 0.004:.6f}.png", h, w)
    if gt:
        with open(f"{root}/groundtruth.txt", "w") as fp:
            for k, m in enumerate(_pose_rows(n)):
                t = 1305031102.175304 + k * dt + 0.001
                fp.write(f"{t:.6f} {_quat_line(m)}\n")


def write_euroc(root, n=4):
    for k in range(n):
        ts = 1403636579763555584 + k * 50000000
        for cam in ("cam0", "cam1"):
            _img(f"{root}/mav0/{cam}/data/{ts}.png", 480, 752)
    d = f"{root}/mav0/state_groundtruth_estimate0"
    os.makedirs(d)
    with open(f"{d}/data.csv", "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for k, m in enumerate(_pose_rows(2 * n)):
            from scipy.spatial.transform import Rotation
            x, y, z, w = Rotation.from_matrix(m[:3, :3]).as_quat()
            ts = 1403636579763555584 + k * 25000000 + 1000
            f.write(f"{ts},{m[0, 3]},{m[1, 3]},{m[2, 3]},{w},{x},{y},{z}\n")


def write_azure(root, n=3, h=48, w=64):
    for k in range(n):
        _img(f"{root}/color/{k:05d}.jpg", h, w)
        _depth(f"{root}/depth/{k:05d}.png", h, w)
    os.makedirs(f"{root}/scene")
    with open(f"{root}/scene/trajectory.log", "w") as f:
        for k, m in enumerate(_pose_rows(n)):
            f.write(f"{k} {k} {k + 1}\n")
            for row in m:
                f.write(" ".join(f"{x:.8f}" for x in row) + "\n")


def write_cofusion(root, n=3, h=48, w=64):
    for k in range(n):
        _img(f"{root}/colour/Color{k:04d}.png", h, w)


# dataset -> (writer, cam overrides, extra config)
CASES = {
    "replica": (write_replica, {}, {}),
    "replica_stride": (write_replica, {}, {"stride": 2}),
    "scannet": (write_scannet, {}, {"data": {"max_frames": 10}}),
    "tumrgbd": (write_tum, {}, {}),
    "eth3d": (lambda r: write_tum(r, gt=True, dt=0.05), {}, {}),
    "eth3d_test_split": (lambda r: write_tum(r, gt=False, dt=0.05), {}, {}),
    "euroc": (write_euroc, {"H": 480, "W": 752, "fx": 435.2046959714599,
                            "fy": 435.2046959714599,
                            "cx": 367.4517211914062,
                            "cy": 252.2008514404297, "H_out": 96,
                            "W_out": 128, "H_edge": 8, "W_edge": 8}, {}),
    "azure": (write_azure, {"distortion": [0.1, -0.05, 0.001, 0.002, 0.0]},
              {}),
    "cofusion": (write_cofusion, {}, {}),
    "synthetic": (None, {"H_out": 24, "W_out": 32},
                  {"data": {"n_frames": 3}}),
}


def _cfg(name, root):
    from goslam_tpu.config import default_config, update_recursive
    _, cam, extra = CASES[name]
    cfg = default_config()
    update_recursive(cfg, {
        "dataset": name.split("_")[0],
        "cam": {"H": 48, "W": 64, "fx": 50.0, "fy": 40.0, "cx": 31.5,
                "cy": 23.5, "H_out": 24, "W_out": 32, "H_edge": 2,
                "W_edge": 4, "png_depth_scale": 1000.0, **cam},
        "data": {"input_folder": root}})
    update_recursive(cfg, extra)
    return cfg


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b)) \
        and np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name", list(CASES))
def test_dataset_matches_jax(name, tmp_path):
    from goslam_tpu.data.datasets import get_dataset as jax_get
    from goslam_tpu_torch.data.datasets import get_dataset

    root = str(tmp_path / name)
    os.makedirs(root)
    writer = CASES[name][0]
    if writer is not None:
        writer(root)
    cfg = _cfg(name, root)
    ds, jds = get_dataset(cfg), jax_get(cfg)
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) > 0
    assert _equal(ds.timestamps, jds.timestamps)
    if name == "eth3d_test_split":
        assert ds.poses is None
    for i in range(len(ds)):
        item, jitem = ds[i], jds[i]
        assert len(item) == len(jitem) == 5
        assert item[0] == jitem[0]
        for a, b in zip(item[1:], jitem[1:]):
            assert _equal(a, b), (name, i)
    img = ds[0][1]
    rig = 2 if name == "euroc" else 1
    assert img.shape == (rig, cfg["cam"]["H_out"], cfg["cam"]["W_out"], 3)
    assert img.dtype == np.float32


def test_registry_is_the_jax_packages():
    from goslam_tpu.data import datasets as jd
    from goslam_tpu_torch.data import datasets as d
    assert sorted(d.dataset_dict) == sorted(jd.dataset_dict)
    for k, cls in d.dataset_dict.items():
        assert cls.__name__ == jd.dataset_dict[k].__name__


def test_save_config_matches_jax(tmp_path):
    from goslam_tpu.config import load_config as jax_load
    from goslam_tpu.config import save_config as jax_save
    from goslam_tpu_torch.config import load_config, save_config

    cfg = load_config(os.path.join(ROOT, "configs", "EuRoC",
                                   "MH_01_easy.yaml"))
    cfg["data"]["max_frames"] = 7
    save_config(cfg, str(tmp_path / "port.yaml"))
    jax_save(cfg, str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == \
        (tmp_path / "jax.yaml").read_text()
    assert load_config(str(tmp_path / "port.yaml")) == cfg == \
        jax_load(str(tmp_path / "jax.yaml"))


_NO_CV2 = r"""
import sys
sys.modules["cv2"] = None
from goslam_tpu_torch.config import default_config, update_recursive
from goslam_tpu_torch.data import datasets
cfg = update_recursive(default_config(), {
    "dataset": "synthetic", "cam": {"H_out": 16, "W_out": 24},
    "data": {"n_frames": 2, "input_folder": sys.argv[1]}})
assert datasets.get_dataset(cfg)[1][1].shape == (1, 16, 24, 3)
cfg["dataset"] = "replica"
ds = datasets.get_dataset(cfg)
try:
    ds[0]
except ImportError as e:
    print("ImportError:", e)
"""


def test_datasets_import_and_synthetic_read_without_opencv(tmp_path):
    root = str(tmp_path / "replica")
    write_replica(root, n=2)
    out = subprocess.run([sys.executable, "-c", _NO_CV2, root], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert "ImportError:" in out.stdout and "OpenCV" in out.stdout
