"""Greedy distance-sorted candidate scan with NMS suppression.

The shared core of the two edge-proposal loops (frontend proximity edges
and the backend's global-BA edges): sort a snapshot of the distance
matrix, scan ascending, skip candidates whose cell was NMS-suppressed
after the snapshot (breaking there would starve the graph), and suppress
the accepted candidate's neighborhood.
"""
from __future__ import annotations

import numpy as np


def greedy_nms_scan(d: np.ndarray, thresh: float, nms: int, accept):
    """Scan `d` (mutated in place) in ascending snapshot order.

    accept(di, dj) -> bool is called for each still-eligible candidate;
    it performs the caller's acceptance logic (dedup, voting, appending)
    and returns False when capacity is reached, which stops the scan.
    After every accept() call that returns True the candidate's
    [di±nms, dj±nms] neighborhood is suppressed.
    """
    ilen, jlen = d.shape
    # stable sort: equal-distance ties break by flat index
    order = np.argsort(d, axis=None, kind="stable")
    snap = d.reshape(-1)[order]
    order = order[snap <= thresh]
    for k in order:
        di, dj = int(k // jlen), int(k % jlen)
        if d[di, dj] > thresh:
            continue  # suppressed after the sort snapshot: skip, not stop
        if not accept(di, dj):
            break
        d[max(0, di - nms):di + nms + 1,
          max(0, dj - nms):dj + nms + 1] = np.inf
