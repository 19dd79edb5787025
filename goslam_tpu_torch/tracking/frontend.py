"""Frontend: local windowed BA with keyframe management.

The system initializes after `warmup` keyframes with neighborhood and
proximity edges and 8+8 update iterations; afterwards every new keyframe
triggers age pruning, proximity edge proposal, iters1 update steps, a
keyframe-distance test (removing a redundant keyframe) and iters2 more
update steps.  Loop closing inside the frontend (``enable_loop``) is not
ported yet.
"""
from __future__ import annotations

import torch

from .factor_graph import FactorGraph, resolve_dtype
from .video import VideoBuffer


class Frontend:
    def __init__(self, net, video: VideoBuffer, cfg: dict):
        t = cfg["tracking"]
        f = t["frontend"]
        if f.get("enable_loop", False):
            raise NotImplementedError(
                "frontend loop closing (Backend.loop_ba) is not ported yet "
                "(ROADMAP.md, queue A item 7); set tracking.frontend."
                "enable_loop: False")
        self.video = video
        self.warmup = t["warmup"]
        self.beta = t["beta"]
        self.max_age = 25
        self.iters1 = 4
        self.iters2 = 2

        self.keyframe_thresh = f["keyframe_thresh"]
        self.frontend_window = f["window"]
        self.frontend_thresh = f["thresh"]
        self.frontend_radius = f["radius"]
        self.frontend_nms = f["nms"]

        self.graph = FactorGraph(
            video, net, max_factors=f["max_factors"], corr_impl="volume",
            upsample=t.get("upsample", False),
            inac_capacity=2 * f["max_factors"],
            compute_dtype=resolve_dtype(t.get("compute_dtype")))

        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0

    @torch.no_grad()
    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    def _seed_next(self, mean_rows: int):
        """Extrapolate keyframe t1 from the previous one: its pose, and
        its disparity as the mean over the last `mean_rows` keyframes'
        maps (1: the scalar mean of the previous map).  Writes past the
        buffer's end are dropped, as JAX's scatter drops them."""
        v, t1 = self.video, self.t1
        if t1 >= v.buffer:
            return
        v.poses[t1] = v.poses[t1 - 1]
        if mean_rows == 1:
            v.disps[t1] = v.disps[t1 - 1].mean()
        else:
            s = max(0, min(t1 - mean_rows, v.buffer - mean_rows))
            v.disps[t1] = v.disps[s:s + mean_rows].mean(dim=0)

    def _initialize(self):
        self.t0 = 0
        self.t1 = self.video.counter

        self.graph.add_neighborhood_factors(self.t0, self.t1, r=3)
        for _ in range(8):
            self.graph.update(t0=1, use_inactive=True)

        self.graph.add_proximity_factors(t0=0, t1=0, rad=2, nms=2,
                                         thresh=self.frontend_thresh,
                                         remove=False)
        for _ in range(8):
            self.graph.update(t0=1, use_inactive=True)

        self._seed_next(4)
        self.is_initialized = True
        self.video.dirty[:self.t1] = True
        self.graph.rm_factors(
            self.graph.valid & (self.graph.ii < self.warmup - 4), store=True)

    def _update(self):
        self.count += 1
        self.t1 += 1

        self.graph.rm_factors(
            self.graph.valid & (self.graph.age > self.max_age), store=True)

        self.graph.add_proximity_factors(
            max(self.t1 - 5, 0), max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True)

        # the new keyframe's disparity starts from sensor depth where
        # there is one
        v, k = self.video, self.t1 - 1
        v.disps[k] = torch.where(v.disps_sens[k] > 0, v.disps_sens[k],
                                 v.disps[k])

        for _ in range(self.iters1):
            self.graph.update(use_inactive=True)

        d = float(self.video.distance([self.t1 - 3], [self.t1 - 2],
                                      beta=self.beta)[0])
        if d < self.keyframe_thresh:
            self.graph.rm_keyframe(self.t1 - 2)
            self.t1 -= 1
        else:
            for _ in range(self.iters2):
                self.graph.update(use_inactive=True)

        self._seed_next(1)
