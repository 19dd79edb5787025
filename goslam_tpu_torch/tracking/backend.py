"""Backend: global dense bundle adjustment and loop closing.

Builds an edge set over [t_start, t_end) with ``proposal.propose_edges``
(in loop mode the rows are the last ``loop_window`` keyframes, and a
candidate must also pass a neighbourhood-consistency vote), then runs the
low-memory update (alt-corr + edge-chunked GRU + full DBA) over it.  With
a ``ShardMesh`` (``mesh=``) the low-memory update shards its edges over
the mesh, in global BA and in loop closing alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .factor_graph import FactorGraph, resolve_dtype
from .proposal import propose_edges
from .video import VideoBuffer


class Backend:
    def __init__(self, net, video: VideoBuffer, cfg: dict, mesh=None):
        t = cfg["tracking"]
        b = t["backend"]
        self.model = net
        self.video = video
        self.mesh = mesh
        self.beta = t["beta"]
        self.backend_thresh = b["thresh"]
        self.backend_radius = b["radius"]
        self.backend_nms = b["nms"]
        self.backend_loop_window = b["loop_window"]
        self.backend_loop_thresh = b["loop_thresh"]
        self.backend_loop_radius = b["loop_radius"]
        self.backend_loop_nms = b["loop_nms"]
        self.compute_dtype = resolve_dtype(t.get("compute_dtype"))
        # loop candidates that passed the vote: in the last loop_ba call,
        # and in all of them
        self.last_loop_accepts = 0
        self.total_loop_accepts = 0

    def _propose_edges(self, t_start, t_end, t_start_loop, radius, nms,
                       thresh, max_factors, loop):
        """``proposal.propose_edges`` with rows [t_start_loop, t_end),
        columns [t_start, t_end) and near pairs from t_start_loop on,
        counting the loop candidates accepted.  Returns the edges."""
        es, n_acc = propose_edges(self.video, t_start_loop, t_start, t_end,
                                  radius, nms, thresh, max_factors,
                                  self.beta, loop, near_from=t_start_loop)
        self.last_loop_accepts += n_acc
        self.total_loop_accepts += n_acc
        return es

    def ba(self, t_start, t_end, steps, graph: FactorGraph, nms, radius,
           thresh, max_factors, t_start_loop=None, loop=False,
           motion_only=False):
        """Edge proposal + low-memory global update.  Returns the number
        of edges optimized (0 when too few were proposed)."""
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        if t_start_loop < t_start:
            raise ValueError("t_start_loop must not lie before t_start")
        with trace.span("slam.propose"):
            es = self._propose_edges(t_start, t_end, t_start_loop, radius,
                                     nms, thresh, max_factors, loop)
            if len(es) < 3:
                return 0
            ii, jj = np.asarray(sorted(set(es)), np.int64).T
            graph.add_factors(ii, jj, remove=True)
        edge_num = graph.n_edges()
        # the dense damping regime (lm=1e-5, ep=1e-2) even for loop
        # closing, as in the JAX package
        graph.update_lowmem(t0=t_start_loop + 1, t1=t_end, iters=2,
                            steps=steps, max_t=t_end, ba_type="dense",
                            motion_only=motion_only)
        graph.clear_edges()
        self.video.dirty[t_start:t_end] = True
        return edge_num

    def _graph(self, max_factors) -> FactorGraph:
        return FactorGraph(self.video, self.model, max_factors=max_factors,
                           corr_impl="alt", inac_capacity=-1,
                           compute_dtype=self.compute_dtype, mesh=self.mesh)

    @torch.no_grad()
    def dense_ba(self, t_start, t_end, steps=6, motion_only=False):
        """Full-sequence BA over keyframes [t_start, t_end).  Returns
        (number of keyframes, number of edges)."""
        n = t_end - t_start
        max_factors = (int(self.video.stereo)
                       + (self.backend_radius + 2) * 2) * n
        with trace.span("slam.global_ba"):
            n_edges = self.ba(t_start, t_end, steps,
                              self._graph(max_factors), self.backend_nms,
                              self.backend_radius, self.backend_thresh,
                              max_factors, motion_only=motion_only)
        trace.add("global_ba.calls")
        trace.add("global_ba.edges", n_edges)
        return n, n_edges

    @torch.no_grad()
    def loop_ba(self, t_start, t_end, steps=6, motion_only=False,
                local_graph=None):
        """Windowed loop closing: the last `loop_window` keyframes are
        matched against all of [t_start, t_end), in a graph seeded with
        the live edges of `local_graph` (the frontend's): endpoints and
        ages on the host, hidden states, targets and weights on the
        device.  Returns (window length, number of edges)."""
        with trace.span("slam.loop_closing"):
            window, n_edges = self._loop_ba(t_start, t_end, steps,
                                            motion_only, local_graph)
        trace.add("loop_closing.calls")
        trace.add("loop_closing.edges", n_edges)
        return window, n_edges

    def _loop_ba(self, t_start, t_end, steps, motion_only, local_graph):
        max_factors = 8 * self.backend_loop_window
        t_start_loop = max(0, t_end - self.backend_loop_window)
        self.last_loop_accepts = 0

        graph = self._graph(max_factors)
        if local_graph is not None:
            graph.seed_live_edges(local_graph)

        left = max_factors - graph.n_edges()
        n_edges = self.ba(t_start, t_end, steps, graph,
                          self.backend_loop_nms, self.backend_loop_radius,
                          self.backend_loop_thresh, left,
                          t_start_loop=t_start_loop, loop=True,
                          motion_only=motion_only)
        return t_end - t_start_loop, n_edges
