"""Backend: global dense bundle adjustment.

Builds an edge set over [t_start, t_end) from the flow-distance matrix
(computed on the device; the greedy NMS selection runs on the host), then
runs the low-memory update (alt-corr + edge-chunked GRU + full DBA) over
it.  Loop closing (``loop_ba``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.greedy import greedy_nms_scan
from .factor_graph import FactorGraph, resolve_dtype
from .video import VideoBuffer


class Backend:
    def __init__(self, net, video: VideoBuffer, cfg: dict):
        t = cfg["tracking"]
        b = t["backend"]
        self.model = net
        self.video = video
        self.beta = t["beta"]
        self.upsample = t.get("upsample", False)
        self.backend_thresh = b["thresh"]
        self.backend_radius = b["radius"]
        self.backend_nms = b["nms"]
        self.compute_dtype = resolve_dtype(t.get("compute_dtype"))

    def _propose_edges(self, t_start, t_end, radius, nms, thresh,
                       max_factors):
        """Greedy distance-sorted edge proposal: every pair within
        `radius`, then the closest remaining pairs under `thresh`, with
        NMS suppression, up to `max_factors` edges."""
        n = t_end - t_start
        ii0, jj0 = np.meshgrid(np.arange(t_start, t_end),
                               np.arange(t_start, t_end), indexing="ij")
        ii_f, jj_f = ii0.reshape(-1), jj0.reshape(-1)
        d = np.array(self.video.distance(ii_f, jj_f, beta=self.beta),
                     np.float64)
        d[ii_f - radius < jj_f] = np.inf
        d[d > thresh] = np.inf
        d = d.reshape(n, n)

        es = []
        for i in range(t_start, t_end):
            for j in range(max(i - radius, t_start), i):
                es.append((i, j))
                es.append((j, i))
                di, dj = i - t_start, j - t_start
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        def accept(di, dj):
            if len(es) > max_factors:
                return False
            es.append((di + t_start, dj + t_start))
            es.append((dj + t_start, di + t_start))
            return True

        greedy_nms_scan(d, thresh, nms, accept)
        return es

    def ba(self, t_start, t_end, steps, graph: FactorGraph, nms, radius,
           thresh, max_factors, motion_only=False):
        """Edge proposal + low-memory global update.  Returns the number
        of edges optimized (0 when too few were proposed)."""
        es = self._propose_edges(t_start, t_end, radius, nms, thresh,
                                 max_factors)
        if len(es) < 3:
            return 0
        ii, jj = np.asarray(sorted(set(es)), np.int64).T
        graph.add_factors(ii, jj, remove=True)
        edge_num = graph.n_edges()
        graph.update_lowmem(t0=t_start + 1, t1=t_end, iters=2, steps=steps,
                            max_t=t_end, ba_type="dense",
                            motion_only=motion_only)
        graph.clear_edges()
        self.video.dirty[t_start:t_end] = True
        return edge_num

    @torch.no_grad()
    def dense_ba(self, t_start, t_end, steps=6, motion_only=False):
        """Full-sequence BA over keyframes [t_start, t_end).  Returns
        (number of keyframes, number of edges)."""
        n = t_end - t_start
        max_factors = (self.backend_radius + 2) * 2 * n
        graph = FactorGraph(self.video, self.model, max_factors=max_factors,
                            corr_impl="alt", upsample=self.upsample,
                            inac_capacity=-1,
                            compute_dtype=self.compute_dtype)
        n_edges = self.ba(t_start, t_end, steps, graph, self.backend_nms,
                          self.backend_radius, self.backend_thresh,
                          max_factors, motion_only=motion_only)
        return n, n_edges
