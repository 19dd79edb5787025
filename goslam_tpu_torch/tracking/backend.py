"""Backend: global dense bundle adjustment and loop closing.

Builds an edge set over [t_start, t_end) from the flow-distance matrix
(computed on the device; the greedy NMS selection runs on the host in
native code, ``native/greedy.cpp``; in loop mode a candidate must also
pass a neighbourhood-consistency vote),
then runs the low-memory update (alt-corr + edge-chunked GRU + full DBA)
over it.  With a ``ShardMesh`` (``mesh=``) the low-memory update shards
its edges over the mesh, in global BA and in loop closing alike.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.greedy import greedy_nms_scan
from .factor_graph import FactorGraph, resolve_dtype
from .video import VideoBuffer

# half-width of the neighbourhood that votes on a loop candidate
LOOP_VOTE_NEIGH = 1


def propose_scan_plain(d, rawd, thresh, nms, es_len0, max_factors, loop,
                       n_neigh, t_start_loop, t_start, t_end):
    """Plain version of ``native.greedy_propose`` (the scan that
    ``Backend._propose_edges`` runs), with its arguments and results: the
    Python scan of ``utils.greedy`` over ``d`` (mutated), accepting a
    candidate while the edges number at most ``max_factors``; in loop mode
    only when more than half of its (2 n_neigh + 1)^2 neighbourhood lies
    under ``thresh`` in ``rawd``, and then with all of those neighbours.
    Returns (pairs [N, 2], the number of loop candidates accepted)."""
    pairs, n_acc = [], 0

    def accept(di, dj):
        nonlocal n_acc
        if es_len0 + len(pairs) > max_factors:
            return False
        i, j = di + t_start_loop, dj + t_start
        if not loop:
            pairs.extend([(i, j), (j, i)])
            return True
        sub, votes = [], 0
        for si in range(max(i - n_neigh, t_start_loop),
                        min(i + n_neigh + 1, t_end)):
            for sj in range(max(j - n_neigh, t_start),
                            min(j + n_neigh + 1, t_end)):
                if rawd[si - t_start_loop, sj - t_start] <= thresh:
                    votes += 1
                    if si != sj:
                        sub.append((si, sj))
        if votes > (2 * n_neigh + 1) ** 2 // 2:
            pairs.extend(sub)
            n_acc += 1
        return True

    greedy_nms_scan(d, thresh, nms, accept)
    return np.asarray(pairs, np.int32).reshape(-1, 2), n_acc


class Backend:
    def __init__(self, net, video: VideoBuffer, cfg: dict, mesh=None):
        t = cfg["tracking"]
        b = t["backend"]
        self.model = net
        self.video = video
        self.mesh = mesh
        self.beta = t["beta"]
        self.upsample = t.get("upsample", False)
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
                       thresh, max_factors, loop, existing_es):
        """Greedy distance-sorted edge proposal: every pair within
        `radius` (and in stereo, outside loop mode, every frame's
        self-edge), then the closest remaining pairs under `thresh`, with
        NMS suppression, up to `max_factors` edges.  Rows are the frames
        [t_start_loop, t_end), columns [t_start, t_end).  In loop mode a
        candidate is accepted only when more than half of its 3x3
        neighbourhood lies under `thresh` in the unmasked distances, and
        then brings all of those neighbours as edges.  The scan is
        ``native.greedy_propose``; a failed build of it raises (its plain
        version ``propose_scan_plain`` is the tests' reference)."""
        ilen = t_end - t_start_loop
        jlen = t_end - t_start
        ii0, jj0 = np.meshgrid(np.arange(t_start_loop, t_end),
                               np.arange(t_start, t_end), indexing="ij")
        ii_f, jj_f = ii0.reshape(-1), jj0.reshape(-1)
        d = np.array(self.video.distance(ii_f, jj_f, beta=self.beta),
                     np.float64)
        rawd = d.reshape(ilen, jlen).copy()
        d[ii_f - radius < jj_f] = np.inf
        d[d > thresh] = np.inf
        d = d.reshape(ilen, jlen)

        es = list(existing_es)
        for i in range(t_start_loop, t_end):
            if self.video.stereo and not loop:
                # the stereo self-edge, and no proposal at its cell
                es.append((i, i))
                d[i - t_start_loop, i - t_start] = np.inf
            for j in range(max(i - radius, t_start_loop), i):
                es.append((i, j))
                es.append((j, i))
                di, dj = i - t_start_loop, j - t_start
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        pairs, n_acc = native.greedy_propose(
            d, rawd, thresh, nms, len(es), max_factors, loop,
            LOOP_VOTE_NEIGH, t_start_loop, t_start, t_end)
        es.extend((int(i), int(j)) for i, j in pairs)
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
        es = self._propose_edges(t_start, t_end, t_start_loop, radius, nms,
                                 thresh, max_factors, loop, [])
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
                           corr_impl="alt", upsample=self.upsample,
                           inac_capacity=-1,
                           compute_dtype=self.compute_dtype, mesh=self.mesh)

    @torch.no_grad()
    def dense_ba(self, t_start, t_end, steps=6, motion_only=False):
        """Full-sequence BA over keyframes [t_start, t_end).  Returns
        (number of keyframes, number of edges)."""
        n = t_end - t_start
        max_factors = (int(self.video.stereo)
                       + (self.backend_radius + 2) * 2) * n
        n_edges = self.ba(t_start, t_end, steps, self._graph(max_factors),
                          self.backend_nms, self.backend_radius,
                          self.backend_thresh, max_factors,
                          motion_only=motion_only)
        return n, n_edges

    @torch.no_grad()
    def loop_ba(self, t_start, t_end, steps=6, motion_only=False,
                local_graph=None):
        """Windowed loop closing: the last `loop_window` keyframes are
        matched against all of [t_start, t_end), in a graph seeded with
        the live edges of `local_graph` (the frontend's): endpoints and
        ages on the host, hidden states, targets and weights on the
        device.  Returns (window length, number of edges)."""
        max_factors = 8 * self.backend_loop_window
        t_start_loop = max(0, t_end - self.backend_loop_window)
        self.last_loop_accepts = 0

        graph = self._graph(max_factors)
        if local_graph is not None:
            sel = np.where(local_graph.valid)[0]
            n = len(sel)
            graph.ii[:n] = local_graph.ii[sel]
            graph.jj[:n] = local_graph.jj[sel]
            graph.age[:n] = local_graph.age[sel]
            graph.valid[:n] = True
            src = torch.as_tensor(sel, device=self.video.device)
            graph.net[:n] = local_graph.net[src]
            graph.target[:n] = local_graph.target[src]
            graph.weight[:n] = local_graph.weight[src]

        left = max_factors - graph.n_edges()
        n_edges = self.ba(t_start, t_end, steps, graph,
                          self.backend_loop_nms, self.backend_loop_radius,
                          self.backend_loop_thresh, left,
                          t_start_loop=t_start_loop, loop=True,
                          motion_only=motion_only)
        return t_end - t_start_loop, n_edges
