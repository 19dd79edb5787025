"""Headless live viewer, point-cloud export and image metrics.

  * ``LiveViewer``: consumes the video's dirty keyframes, keeps their
    filtered points and camera poses, and writes PLY snapshots (the live
    viewer of the JAX package, without a window);
  * ``export_pointcloud``: the multiview-filtered keyframe cloud as a
    coloured PLY;
  * ``save_render_panel``: rendered against ground-truth colour and depth
    as a PNG, with PSNR and depth errors (``psnr``, ``depth_metrics``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..mapping.mesher import save_ply
from ..ops import lie, projective


class LiveViewer:
    """The viewer's dirty-index protocol without a window: ``update``
    re-unprojects the keyframes whose ``video.dirty`` bit is set through
    the depth-consistency filter (a point is kept where at least
    ``filter_count`` neighbour frames agree within ``filter_thresh`` and
    its disparity is above 1 % of its frame's mean), keeps their points
    and camera poses, and clears their bits.  The viewer's keys are
    methods: ``increase_filter`` / ``decrease_filter`` double or halve
    the threshold (and mark every keyframe dirty), ``save_pointcloud``
    and ``save_cameras`` write the cloud and the camera frusta."""

    def __init__(self, video, save_root: str, filter_thresh: float = 0.005,
                 filter_count: int = 2, stride: int = 1,
                 save_every: int = 0):
        self.video = video
        self.filter_thresh = filter_thresh
        self.filter_count = filter_count
        self.stride = stride
        self.save_every = save_every
        self.points = {}      # keyframe -> (points [M, 3], colours [M, 3] u8)
        self.cameras = {}     # keyframe -> c2w 4x4
        self.updates = 0
        self.last_id = -1
        self.out_dir = os.path.join(save_root, "pointcloud")
        os.makedirs(self.out_dir, exist_ok=True)

    def increase_filter(self):
        self.filter_thresh *= 2.0
        self.video.dirty[:self.video.counter] = True

    def decrease_filter(self):
        self.filter_thresh *= 0.5
        self.video.dirty[:self.video.counter] = True

    def _compute(self, poses, disps, intrinsics):
        """Every keyframe's world points [T, h, w, 3], filter masks [T, h,
        w] and c2w [T, 4, 4], on the video's device, from its first T
        keyframes."""
        count = projective.depth_consistency_count(poses, disps, intrinsics,
                                                   self.filter_thresh)
        pts = projective.iproj_world(poses, disps.clamp(min=1e-8),
                                     intrinsics)
        masks = (count >= self.filter_count) & \
            (disps > 0.01 * disps.mean(dim=(1, 2), keepdim=True))
        return pts, masks, lie.matrix(lie.inv(poses))

    def update(self) -> int:
        """Consume the dirty keyframes; returns how many changed."""
        video = self.video
        n = video.counter
        dirty = np.flatnonzero(video.dirty[:n])
        if len(dirty) == 0:
            return 0
        # full-resolution points when upsampled disparities exist
        full = float(video.disps_up[:1].abs().sum()) > 0
        disps = video.disps_up if full else video.disps
        scale = 1 if full else video.device_scale
        intr = video.intrinsics * (video.device_scale / scale)
        pts, masks, c2ws = self._compute(video.poses[:n], disps[:n], intr)
        sel = torch.as_tensor(dirty, device=pts.device)
        pts, masks, c2ws = (t[sel].cpu().numpy() for t in (pts, masks, c2ws))
        imgs = video.images[sel].cpu().numpy()
        if imgs.shape[1] != masks.shape[1]:   # images at full resolution
            s = video.device_scale
            imgs = imgs[:, 3::s, 3::s][:, :masks.shape[1], :masks.shape[2]]

        video.dirty[dirty] = False
        st = self.stride
        for k, ix in enumerate(dirty):
            m = masks[k][::st, ::st]
            self.points[int(ix)] = (
                pts[k][::st, ::st][m].astype(np.float32),
                (np.clip(imgs[k][::st, ::st][m], 0, 1) * 255)
                .astype(np.uint8))
            self.cameras[int(ix)] = c2ws[k]

        self.updates += 1
        if self.save_every and self.updates % self.save_every == 0:
            self.save_pointcloud()
        return len(dirty)

    def save_pointcloud(self) -> str:
        """The accumulated cloud as pointcloud/<last keyframe>_pc.ply."""
        if not self.points:
            return ""
        self.last_id = max(self.points)
        P = np.concatenate([p for p, _ in self.points.values()])
        C = np.concatenate([c for _, c in self.points.values()])
        path = os.path.join(self.out_dir, f"{self.last_id:05d}_pc.ply")
        save_ply(path, P, np.zeros((0, 3), np.int32), C)
        return path

    def save_cameras(self) -> str:
        """The camera frusta as a PLY line set, pointcloud/cameras.ply."""
        if not self.cameras:
            return ""
        f = 0.08
        box = np.asarray([[0, 0, 0], [-f, -f, 2 * f], [f, -f, 2 * f],
                          [f, f, 2 * f], [-f, f, 2 * f]], np.float32)
        seg = [(0, 1), (0, 2), (0, 3), (0, 4),
               (1, 2), (2, 3), (3, 4), (4, 1)]
        verts, edges = [], []
        for i, (_, c2w) in enumerate(sorted(self.cameras.items())):
            verts.append(box @ c2w[:3, :3].T + c2w[:3, 3])
            edges += [(5 * i + a, 5 * i + b) for a, b in seg]
        path = os.path.join(self.out_dir, "cameras.ply")
        _save_ply_lines(path, np.concatenate(verts),
                        np.asarray(edges, np.int32))
        return path


def _save_ply_lines(path: str, verts: np.ndarray, edges: np.ndarray):
    with open(path, "wb") as fh:
        fh.write((
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n").encode())
        for v in verts:
            fh.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
        for a, b in edges:
            fh.write(f"{a} {b}\n".encode())


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(((a - b) ** 2).mean())
    return float(10.0 * np.log10(max_val ** 2 / max(mse, 1e-12)))


def depth_metrics(est: np.ndarray, gt: np.ndarray):
    m = gt > 0
    err = np.abs(est[m] - gt[m])
    return {"mae": float(err.mean()),
            "rmse": float(np.sqrt((err ** 2).mean()))}


def export_pointcloud(path: str, video, stride: int = 4,
                      max_frames: Optional[int] = None) -> int:
    """The multiview-filtered keyframe cloud as a coloured PLY; returns
    the number of points."""
    n = video.filtered_id if video.filtered_id > 0 else video.counter
    if max_frames:
        n = min(n, max_frames)
    if n <= 0:
        return 0
    masks = (video.mask_filtered[:n] > 0).cpu().numpy()
    imgs = video.images[:n].cpu().numpy()
    pts = projective.iproj_world(
        video.poses_filtered[:n], video.disps_filtered[:n].clamp(min=1e-6),
        video.intrinsics * video.device_scale).cpu().numpy()
    sub = (slice(None), slice(None, None, stride), slice(None, None, stride))
    m = masks[sub]
    P = pts[sub][m].astype(np.float32)
    C = (np.clip(imgs[sub][m], 0, 1) * 255).astype(np.uint8)
    save_ply(path, P, np.zeros((0, 3), np.int32), C)
    return len(P)


def save_render_panel(path: str, gt_color, gt_depth, est_color, est_depth,
                      est_depth_var=None):
    """A 2x3 panel of rendered against ground-truth colour and depth, as a
    PNG; returns the PSNR and depth errors."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt_color = np.asarray(gt_color)
    est_color = np.clip(np.asarray(est_color), 0, 1)
    gt_depth = np.asarray(gt_depth)
    est_depth = np.asarray(est_depth)

    fig, ax = plt.subplots(2, 3, figsize=(13, 7))
    ax[0, 0].imshow(gt_color)
    ax[0, 0].set_title("GT color")
    ax[0, 1].imshow(est_color)
    ax[0, 1].set_title(f"rendered (PSNR {psnr(est_color, gt_color):.2f} dB)")
    ax[0, 2].imshow(np.abs(est_color - gt_color).mean(-1), cmap="hot")
    ax[0, 2].set_title("|color err|")
    vmax = np.percentile(gt_depth[gt_depth > 0], 99) if (gt_depth > 0).any() \
        else 1.0
    ax[1, 0].imshow(gt_depth, cmap="turbo", vmin=0, vmax=vmax)
    ax[1, 0].set_title("GT depth")
    dm = depth_metrics(est_depth, gt_depth)
    ax[1, 1].imshow(est_depth, cmap="turbo", vmin=0, vmax=vmax)
    ax[1, 1].set_title(f"rendered depth (MAE {dm['mae']:.3f})")
    if est_depth_var is not None:
        ax[1, 2].imshow(np.sqrt(np.asarray(est_depth_var)), cmap="viridis")
        ax[1, 2].set_title("depth sigma")
    else:
        ax[1, 2].imshow(np.abs(est_depth - gt_depth), cmap="hot")
        ax[1, 2].set_title("|depth err|")
    for a in ax.ravel():
        a.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return {"psnr": psnr(est_color, gt_color), **dm}
