"""Pose trajectory filler: interpolate and refine non-keyframe poses.

At termination every input frame gets a pose by geodesic interpolation
between its bracketing keyframes, refined with 6 motion-only update
iterations against those keyframes (edges keyframe -> frame, so the
keyframes' disparities drive the reprojection).  Frames are appended to
the video temporarily, a batch at a time, and removed again.  One factor
graph serves every batch of a call, so an update step of a shape an
earlier batch ran is replayed (on CUDA, a CUDA graph).

As in the JAX package, the filler's graph runs in the default bf16
compute dtype whatever ``tracking.compute_dtype`` says.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import lie
from .factor_graph import FactorGraph
from .motion_filter import MotionFilter
from .video import VideoBuffer


class TrajectoryFiller:
    def __init__(self, net, video: VideoBuffer, motion_filter: MotionFilter,
                 batch: int = 16):
        self.model = net
        self.video = video
        self.batch = batch
        self._encode = motion_filter.encode

    def _fill_batch(self, graph, timestamps, images, intrinsics):
        video = self.video
        dev = video.device
        N = video.counter
        M = len(timestamps)
        if N + M > video.buffer:
            raise RuntimeError("keyframe buffer too small for trajectory "
                               "filling; raise tracking.buffer")

        ts = video.timestamp[:N].cpu().numpy()
        tt = np.asarray(timestamps, np.float32)

        # bracketing keyframes
        t0 = np.asarray([max(0, int((ts <= t).sum()) - 1) for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        w = (tt - ts[t0]) / (ts[t1] - ts[t0] + 1e-3)
        Gs = lie.interp(video.poses[torch.as_tensor(t0, device=dev)],
                        video.poses[torch.as_tensor(t1, device=dev)],
                        torch.as_tensor(w, dtype=torch.float32, device=dev))

        # the left views are encoded; in stereo every view of the rig
        # gets the left view's features, as the JAX package's broadcast
        # gives them (the filler's edges are never self-edges, so the
        # right view is never read)
        imgs = torch.as_tensor(np.stack(images), dtype=torch.float32,
                               device=dev)
        fmaps = self._encode(imgs)[:, None].expand(
            -1, video.rig, -1, -1, -1)
        zeros_ctx = torch.zeros((video.h8, video.w8, 128),
                                dtype=torch.bfloat16, device=dev)
        for k in range(M):
            intr = torch.as_tensor(intrinsics[k], dtype=torch.float32,
                                   device=dev) / video.device_scale
            video.append(float(tt[k]), Gs[k], 1.0, None, intr,
                         fmaps[k], zeros_ctx, zeros_ctx)

        graph.clear_edges()
        graph.add_factors(t0, np.arange(N, N + M))
        graph.add_factors(t1, np.arange(N, N + M))
        for _ in range(6):
            graph.update(t0=N, t1=N + M, motion_only=True)

        out = video.poses[N:N + M].cpu().numpy()
        video.counter = N
        return out

    @torch.no_grad()
    def __call__(self, stream) -> np.ndarray:
        """stream yields (timestamp, image [rig,ht,wd,3], depth, intrinsics,
        gt_pose).  Returns [n_frames, 7] w2c poses for every frame."""
        graph = FactorGraph(self.video, self.model,
                            max_factors=2 * self.batch + 8,
                            corr_impl="volume", inac_capacity=-1)
        poses: List[np.ndarray] = []
        ts_b, im_b, intr_b = [], [], []
        for (timestamp, image, depth, intrinsics, gt_pose) in stream:
            ts_b.append(timestamp)
            im_b.append(np.asarray(image)[0])
            intr_b.append(intrinsics)
            if len(ts_b) == self.batch:
                poses.append(self._fill_batch(graph, ts_b, im_b, intr_b))
                ts_b, im_b, intr_b = [], [], []
        if ts_b:
            poses.append(self._fill_batch(graph, ts_b, im_b, intr_b))
        return np.concatenate(poses, axis=0)
