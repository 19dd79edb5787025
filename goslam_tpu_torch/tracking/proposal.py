"""Greedy edge proposal, one policy for the frontend's proximity edges
and the backend's global-BA and loop-closing edges: the distance matrix on
the device, the scan on the host in native code (``native/greedy.cpp``; a
failed build of it raises).  ``propose_scan_plain`` is the scan's plain
version, the tests' reference.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..utils.greedy import greedy_nms_scan

# half-width of the neighbourhood that votes on a loop candidate
LOOP_VOTE_NEIGH = 1


def propose_edges(video, r0, c0, t_end, radius, nms, thresh, max_factors,
                  beta, loop, near_from, suppress=()):
    """Greedy distance-sorted edge proposal over rows [r0, t_end) and
    columns [c0, t_end): every pair (i, j), ``max(i - radius, near_from)
    <= j < i``, both ways (and in stereo, outside loop mode, the self-edge
    (i, i)), then the closest remaining pairs under ``thresh`` with NMS
    suppression -- around the pairs taken and around each edge of
    ``suppress`` that lies in the matrix -- until the edges number more
    than ``max_factors``.  In loop mode a candidate is accepted only when
    more than half of its 3x3 neighbourhood lies under ``thresh`` in the
    unmasked distances, and then brings all of those neighbours as edges.
    Returns (the edges in order, the number of loop candidates
    accepted)."""
    ilen, jlen = t_end - r0, t_end - c0
    ii0, jj0 = np.meshgrid(np.arange(r0, t_end), np.arange(c0, t_end),
                           indexing="ij")
    ii_f, jj_f = ii0.reshape(-1), jj0.reshape(-1)
    d = np.array(video.distance(ii_f, jj_f, beta=beta), np.float64)
    rawd = d.reshape(ilen, jlen).copy() if loop else None
    d[ii_f - radius < jj_f] = np.inf
    d[d > thresh] = np.inf
    d = d.reshape(ilen, jlen)

    def suppress_at(i, j):
        di, dj = i - r0, j - c0
        d[max(0, di - nms):di + nms + 1,
          max(0, dj - nms):dj + nms + 1] = np.inf

    for i, j in suppress:
        if r0 <= i < t_end and c0 <= j < t_end:
            suppress_at(i, j)

    es = []
    for i in range(r0, t_end):
        if video.stereo and not loop:
            # the stereo self-edge, and no proposal at its cell
            es.append((i, i))
            d[i - r0, i - c0] = np.inf
        for j in range(max(i - radius, near_from), i):
            es.append((i, j))
            es.append((j, i))
            suppress_at(i, j)

    pairs, n_acc = native.greedy_propose(
        d, rawd, thresh, nms, len(es), max_factors, loop, LOOP_VOTE_NEIGH,
        r0, c0, t_end)
    es.extend((int(i), int(j)) for i, j in pairs)
    return es, n_acc


def propose_scan_plain(d, rawd, thresh, nms, es_len0, max_factors, loop,
                       n_neigh, t_start_loop, t_start, t_end):
    """Plain version of ``native.greedy_propose`` (the scan that
    ``propose_edges`` runs), with its arguments and results: the Python
    scan of ``utils.greedy`` over ``d`` (mutated), accepting a candidate
    while the edges number at most ``max_factors``; in loop mode only when
    more than half of its (2 n_neigh + 1)^2 neighbourhood lies under
    ``thresh`` in ``rawd``, and then with all of those neighbours.
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
