"""Dataset loaders: Replica, ScanNet, TUM-RGBD, ETH3D, EuRoC, Azure,
CoFusion, and the synthetic room.

The port's copy of the JAX package's loaders, frame for frame:
  * resize (H, W) -> (H_out + 2 H_edge, W_out + 2 W_edge), then crop the
    H_edge / W_edge borders; optional undistortion first
  * BGR -> RGB float in [0, 1]
  * intrinsics rescaled by the resize and shifted by the crop
  * depth PNG (divided by png_depth_scale) or EXR, resized nearest
  * items: (index, image [rig, H_out, W_out, 3], depth [H_out, W_out] |
    None, intrinsics [4] (fx fy cx cy), gt c2w pose [4, 4] | None); rig
    is 2 for EuRoC's rectified stereo pair, else 1

Images are decoded and remapped with OpenCV, imported at the first image
read: the synthetic room needs none, and without OpenCV a real dataset's
read raises ImportError.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np


def _cv2():
    """OpenCV, imported at first use."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading a real dataset's images needs OpenCV (the cv2 "
            "module), which is not installed") from e
    cv2.setNumThreads(0)
    return cv2


class BaseDataset:
    def __init__(self, cfg, args=None, device=None):
        self.cfg = cfg
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.distortion = np.asarray(cfg["cam"]["distortion"]) \
            if "distortion" in cfg["cam"] else None

        self.H, self.W = cfg["cam"]["H"], cfg["cam"]["W"]
        self.fx, self.fy = cfg["cam"]["fx"], cfg["cam"]["fy"]
        self.cx, self.cy = cfg["cam"]["cx"], cfg["cam"]["cy"]

        self.H_out, self.W_out = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
        self.H_edge, self.W_edge = cfg["cam"]["H_edge"], cfg["cam"]["W_edge"]

        self.input_folder = cfg["data"]["input_folder"]
        self.stride = cfg.get("stride", 1)
        self.color_paths: list = []
        self.depth_paths: Optional[list] = None
        self.poses: Optional[list] = None
        self.timestamps: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.color_paths)

    def _load_depth(self, path):
        if path is None:
            return None
        cv2 = _cv2()
        if path.endswith(".exr"):
            d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if d.ndim == 3:
                d = d[..., 0]
        else:
            d = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
            d = d / self.png_depth_scale
        return d.astype(np.float32)

    def _process(self, color, depth):
        """resize -> float RGB -> crop; returns (img, depth, intrinsics)."""
        cv2 = _cv2()
        H_out_we = self.H_out + 2 * self.H_edge
        W_out_we = self.W_out + 2 * self.W_edge

        if self.distortion is not None:
            K = np.eye(3)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (self.fx, self.fy,
                                                  self.cx, self.cy)
            color = cv2.undistort(color, K, self.distortion)

        color = cv2.resize(color, (W_out_we, H_out_we))
        color = cv2.cvtColor(color, cv2.COLOR_BGR2RGB).astype(np.float32)
        color = color / 255.0

        sx = W_out_we / self.W
        sy = H_out_we / self.H
        intr = np.asarray([self.fx * sx, self.fy * sy,
                           self.cx * sx, self.cy * sy], np.float32)

        he, we = self.H_edge, self.W_edge
        if he > 0:
            color = color[he:-he]
        if we > 0:
            color = color[:, we:-we]
        intr[2] -= we
        intr[3] -= he

        if depth is not None:
            depth = cv2.resize(depth, (W_out_we, H_out_we),
                               interpolation=cv2.INTER_NEAREST)
            if he > 0:
                depth = depth[he:-he]
            if we > 0:
                depth = depth[:, we:-we]
        return color, depth, intr

    def __getitem__(self, index):
        color = _cv2().imread(self.color_paths[index])
        depth = self._load_depth(self.depth_paths[index]) \
            if self.depth_paths else None
        color, depth, intr = self._process(color, depth)
        pose = self.poses[index] if self.poses is not None else None
        return index, color[None], depth, intr, pose

    def stream(self):
        for i in range(len(self)):
            yield self[i]


class Replica(BaseDataset):
    """results/frame*.jpg + results/depth*.png + traj.txt (one flattened
    c2w per line)."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self._load_poses(f"{self.input_folder}/traj.txt")
        s = self.stride
        self.color_paths = self.color_paths[::s]
        self.depth_paths = self.depth_paths[::s]
        if self.poses is not None:
            self.poses = self.poses[::s]

    def _load_poses(self, path):
        if not os.path.exists(path):
            self.poses = None
            return
        with open(path) as f:
            lines = f.read().splitlines()
        self.poses = [np.asarray(list(map(float, l.split()))).reshape(4, 4)
                      .astype(np.float32) for l in lines]


class ScanNet(BaseDataset):
    """color/*.jpg depth/*.png pose/*.txt (under frames/ or not), sorted
    numerically; ``data.max_frames`` cuts the sequence."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        base = os.path.join(self.input_folder, "frames")
        if not os.path.isdir(base):
            base = self.input_folder
        key = lambda p: int(os.path.basename(p).split(".")[0])
        self.color_paths = sorted(
            glob.glob(os.path.join(base, "color", "*.jpg")), key=key)
        self.depth_paths = sorted(
            glob.glob(os.path.join(base, "depth", "*.png")), key=key)
        pose_paths = sorted(
            glob.glob(os.path.join(base, "pose", "*.txt")), key=key)
        self.poses = []
        for p in pose_paths:
            with open(p) as f:
                self.poses.append(np.asarray(
                    [list(map(float, l.split())) for l in f], np.float32))
        if not self.poses:
            self.poses = None
        mf = cfg["data"].get("max_frames", -1)
        if mf and mf > 0:
            self.color_paths = self.color_paths[:mf]
            self.depth_paths = self.depth_paths[:mf]
            if self.poses:
                self.poses = self.poses[:mf]


def _associate(a_ts, b_ts, max_dt=0.08):
    """Closest-timestamp association: (i, j) for every a_ts[i] whose
    closest b_ts[j] lies within max_dt."""
    pairs = []
    for i, t in enumerate(a_ts):
        j = int(np.argmin(np.abs(b_ts - t)))
        if abs(b_ts[j] - t) < max_dt:
            pairs.append((i, j))
    return pairs


def _tum_read_list(path):
    with open(path) as f:
        data = [l.split() for l in f if l.strip() and l[0] != "#"]
    return np.asarray(data)


def _pose_from_quat(vals):
    """[tx ty tz qx qy qz qw] -> 4x4 c2w."""
    from scipy.spatial.transform import Rotation

    t = np.asarray(vals[:3], np.float64)
    q = np.asarray(vals[3:7], np.float64)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = Rotation.from_quat(q).as_matrix()
    m[:3, 3] = t
    return m


class TUM_RGBD(BaseDataset):
    """rgb.txt / depth.txt / groundtruth.txt, associated by timestamp,
    thinned to 32 frames a second; poses relative to the first."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        self._loadtum(self.input_folder, frame_rate=32)

    def _loadtum(self, datapath, frame_rate=-1):
        img_list = _tum_read_list(os.path.join(datapath, "rgb.txt"))
        depth_list = _tum_read_list(os.path.join(datapath, "depth.txt"))
        pose_path = os.path.join(datapath, "groundtruth.txt")
        pose_list = _tum_read_list(pose_path) \
            if os.path.exists(pose_path) else None

        img_ts = img_list[:, 0].astype(np.float64)
        d_ts = depth_list[:, 0].astype(np.float64)
        pairs_d = dict(_associate(img_ts, d_ts))
        if pose_list is not None:
            p_ts = pose_list[:, 0].astype(np.float64)
            pairs_p = dict(_associate(img_ts, p_ts))
        else:
            pairs_p = {}

        keep = []
        last_t = -np.inf
        for i in range(len(img_ts)):
            if frame_rate > 0 and img_ts[i] - last_t < 1.0 / frame_rate:
                continue
            if i in pairs_d and (pose_list is None or i in pairs_p):
                keep.append(i)
                last_t = img_ts[i]

        self.color_paths = [os.path.join(datapath, img_list[i][1])
                            for i in keep]
        self.depth_paths = [os.path.join(datapath, depth_list[pairs_d[i]][1])
                            for i in keep]
        self.timestamps = img_ts[keep]
        if pose_list is not None:
            poses = [_pose_from_quat(
                pose_list[pairs_p[i]][1:8].astype(np.float64))
                for i in keep]
            inv0 = np.linalg.inv(poses[0])
            self.poses = [(inv0 @ p).astype(np.float32) for p in poses]
        else:
            self.poses = None


class ETH3D(BaseDataset):
    """TUM-format lists; the test split has no groundtruth.txt (its
    trajectory goes to the benchmark server as submission.txt)."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        datapath = self.input_folder
        img_list = _tum_read_list(os.path.join(datapath, "rgb.txt"))
        depth_list = _tum_read_list(os.path.join(datapath, "depth.txt"))
        pose_path = os.path.join(datapath, "groundtruth.txt")
        has_gt = os.path.exists(pose_path)

        img_ts = img_list[:, 0].astype(np.float64)
        d_ts = depth_list[:, 0].astype(np.float64)
        pairs_d = dict(_associate(img_ts, d_ts))

        self.color_paths = [os.path.join(datapath, r[1]) for r in img_list]
        self.depth_paths = [
            os.path.join(datapath, depth_list[pairs_d[i]][1])
            if i in pairs_d else None
            for i in range(len(img_list))]
        self.timestamps = img_ts
        self.image_timestamps = img_ts

        if has_gt:
            pose_list = _tum_read_list(pose_path)
            p_ts = pose_list[:, 0].astype(np.float64)
            pairs_p = dict(_associate(img_ts, p_ts))
            self.poses = [
                _pose_from_quat(pose_list[pairs_p[i]][1:8].astype(np.float64))
                if i in pairs_p else None
                for i in range(len(img_list))]
        else:
            self.poses = None


class EuRoC(BaseDataset):
    """mav0/cam0 and mav0/cam1, rectified with the fixed maps of the
    sequences' calibration (752x480); items carry [left, right]."""
    K_l = np.array([458.654, 0.0, 367.215, 0.0, 457.296, 248.375,
                    0.0, 0.0, 1.0]).reshape(3, 3)
    d_l = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05,
                    0.0])
    R_l = np.array([
        0.999966347530033, -0.001422739138722922, 0.008079580483432283,
        0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
        -0.008089410156878961, -0.007044357138835809, 0.9999424675829176,
    ]).reshape(3, 3)
    P_l = np.array([435.2046959714599, 0, 367.4517211914062, 0,
                    0, 435.2046959714599, 252.2008514404297, 0,
                    0, 0, 1, 0]).reshape(3, 4)
    K_r = np.array([457.587, 0.0, 379.999, 0.0, 456.134, 255.238,
                    0.0, 0.0, 1]).reshape(3, 3)
    d_r = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05,
                    0.0])
    R_r = np.array([
        0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
        0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
        -0.007729688520722713, 0.007064130529506649, 0.999945173484644,
    ]).reshape(3, 3)
    P_r = np.array([435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
                    0, 435.2046959714599, 252.2008514404297, 0,
                    0, 0, 1, 0]).reshape(3, 4)

    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        d = self.input_folder
        self.left_paths = sorted(glob.glob(f"{d}/mav0/cam0/data/*.png"))
        self.right_paths = sorted(glob.glob(f"{d}/mav0/cam1/data/*.png"))
        n = min(len(self.left_paths), len(self.right_paths))
        self.left_paths = self.left_paths[:n:self.stride]
        self.right_paths = self.right_paths[:n:self.stride]
        self.color_paths = self.left_paths
        self.depth_paths = None
        self.timestamps = np.asarray(
            [float(os.path.basename(p).split(".")[0]) * 1e-9
             for p in self.left_paths])
        self.poses = self._load_gt(d)
        self._maps = None           # the rectification maps, at first read

    def _rectify_maps(self):
        if self._maps is None:
            cv2 = _cv2()
            self._maps = tuple(cv2.initUndistortRectifyMap(
                K, dist, R, P[:3, :3], (752, 480), cv2.CV_32F)
                for K, dist, R, P in ((self.K_l, self.d_l, self.R_l, self.P_l),
                                      (self.K_r, self.d_r, self.R_r, self.P_r)))
        return self._maps

    def _load_gt(self, d):
        gt_file = os.path.join(d, "mav0", "state_groundtruth_estimate0",
                               "data.csv")
        if not os.path.exists(gt_file):
            return None
        rows = np.loadtxt(gt_file, delimiter=",", skiprows=1)
        gt_ts = rows[:, 0] * 1e-9
        poses = []
        for t in self.timestamps:
            j = int(np.argmin(np.abs(gt_ts - t)))
            # csv layout: t, px py pz, qw qx qy qz
            p = rows[j, 1:4]
            qw, qx, qy, qz = rows[j, 4:8]
            poses.append(_pose_from_quat(
                np.asarray([*p, qx, qy, qz, qw])))
        inv0 = np.linalg.inv(poses[0])
        return [(inv0 @ m).astype(np.float32) for m in poses]

    def __getitem__(self, index):
        cv2 = _cv2()
        map_l, map_r = self._rectify_maps()
        left = cv2.imread(self.left_paths[index])
        right = cv2.imread(self.right_paths[index])
        left = cv2.remap(left, *map_l, cv2.INTER_LINEAR)
        right = cv2.remap(right, *map_r, cv2.INTER_LINEAR)
        l, _, intr = self._process(left, None)
        r, _, _ = self._process(right, None)
        pose = self.poses[index] if self.poses is not None else None
        return index, np.stack([l, r]), None, intr, pose


class Azure(BaseDataset):
    """color/*.jpg depth/*.png and, if there, scene/trajectory.log."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/color/*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/depth/*.png"))
        traj = os.path.join(self.input_folder, "scene", "trajectory.log")
        self.poses = None
        if os.path.exists(traj):
            with open(traj) as f:
                lines = f.read().splitlines()
            self.poses = []
            for i in range(0, len(lines), 5):
                self.poses.append(np.asarray(
                    [list(map(float, lines[i + k].split()))
                     for k in range(1, 5)], np.float32))


class CoFusion(BaseDataset):
    """colour/*.png depth_noise/*.exr, identity poses."""
    def __init__(self, cfg, args=None, device=None):
        super().__init__(cfg, args, device)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/colour/*.png"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/depth_noise/*.exr"))
        self.poses = [np.eye(4, dtype=np.float32)
                      for _ in self.color_paths]


def _synthetic(cfg, args=None, device=None):
    from .synthetic import Synthetic
    return Synthetic(cfg)


dataset_dict = {
    "synthetic": _synthetic,
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "tum_rgbd": TUM_RGBD,
    "eth3d": ETH3D,
    "euroc": EuRoC,
    "azure": Azure,
    "cofusion": CoFusion,
}


def get_dataset(cfg, args=None, device=None):
    name = cfg["dataset"].lower()
    return dataset_dict[name](cfg, args, device)
