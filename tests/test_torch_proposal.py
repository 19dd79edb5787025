"""The frontend's edge proposal against the JAX package's, on the CPU.

``FactorGraph.add_proximity_factors`` runs ``proposal.propose_edges``, the
backend's proposal on the native scan; the JAX package's runs its own
Python loop and scan.  Both graphs get the same state -- a stub video (its
counter, the stereo flag and a seeded float32 distance matrix) and the
same live and archived edges -- and the test compares the exact edge list,
in order, and the ``remove`` flag that each hands its ``add_factors``.

The cases are the frontend's warm-up call (t0 = t1 = 0, rad 2, nms 2),
its per-keyframe call at each benchmark configuration's published window,
radius, nms and threshold, a capacity that binds, a threshold that is not
a float32 value (13.3) and one above 100.  The matrix has entries exactly
at the threshold's float32 value and at 100, where a scan that compares
in float64 or does not cap at 100 parts from the JAX package's.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from goslam_tpu.tracking.factor_graph import FactorGraph as JFactorGraph
from goslam_tpu_torch.tracking.factor_graph import FactorGraph

# name: (keyframes, t0, t1, rad, nms, beta, thresh, max_factors, remove);
# the per-keyframe calls are the frontend's (rows from t - 5, columns from
# t - window) at the configurations of benchmark/configs
CASES = {
    "warmup": (12, 0, 0, 2, 2, 0.25, 25.0, 75, False),
    "replica-rgbd": (40, 35, 15, 1, 0, 0.75, 25.0, 75, True),
    "euroc-stereo": (40, 35, 15, 1, 1, 0.75, 16.0, 75, True),
    "replica-mono": (70, 65, 20, 2, 1, 0.75, 25.0, 100, True),
    "capacity": (40, 35, 15, 2, 1, 0.75, 25.0, 28, True),
    "thresh-13.3": (40, 35, 15, 1, 1, 0.75, 13.3, 75, True),
    "thresh-150": (40, 35, 15, 1, 1, 0.75, 150.0, 75, True),
}


def _state(rng, n, thresh, warmup, stereo):
    """A symmetric float32 distance matrix over n keyframes, some of it
    exactly at float32(thresh) and at 100, and the live and archived
    edges: at the warm-up the neighbourhood edges the frontend adds first
    (1 < |i - j| <= 3 in stereo, 0 < |i - j| <= 3 else) and no archive;
    else edges from the last 30 keyframes to up to 3 frames away, live,
    and any pairs among them, archived."""
    hi = 2.5 * min(thresh, 120.0)
    dist = rng.uniform(0.0, hi, (n, n))
    dist = ((dist + dist.T) / 2).astype(np.float32)
    for v in (np.float32(thresh), np.float32(100.0)):
        ties = np.triu(rng.random((n, n)) < 0.08)
        dist[ties | ties.T] = v
    if warmup:
        ii, jj = np.nonzero(np.ones((n, n), bool))
        gap = np.abs(ii - jj)
        keep = (gap > int(stereo)) & (gap <= 3)
        return dist, np.stack([ii[keep], jj[keep]], 1), np.zeros((0, 2), int)
    ii = rng.integers(n - 30, n, 30)
    jj = np.clip(ii + rng.integers(-3, 4, 30), 0, n - 1)
    return dist, np.stack([ii, jj], 1), rng.integers(n - 30, n, (30, 2))


def _graph(cls, video, max_factors, live, archived, calls):
    """An instance of cls with only what edge proposal reads: its video,
    capacity and live and archived edges; ``add_factors`` records."""
    g = cls.__new__(cls)
    g.video, g.max_factors = video, max_factors
    cap = 96
    g.ii, g.jj = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    g.valid = np.zeros(cap, bool)
    g.ii[:len(live)], g.jj[:len(live)] = live.T
    g.valid[:len(live)] = True
    g.ii_inac, g.jj_inac = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    g.valid_inac = np.zeros(cap, bool)
    g.ii_inac[:len(archived)], g.jj_inac[:len(archived)] = archived.T
    g.valid_inac[:len(archived)] = True
    g.ii_bad, g.jj_bad = [], []          # read by the JAX package's
    g.add_factors = lambda ii, jj, remove=False: calls.append(
        (np.asarray(ii).tolist(), np.asarray(jj).tolist(), remove))
    return g


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frontend_proposal_matches_jax(seed, stereo, case):
    n, t0, t1, rad, nms, beta, thresh, max_factors, remove = CASES[case]
    rng = np.random.default_rng(seed)
    dist, live, archived = _state(rng, n, thresh, case == "warmup",
                                  stereo)
    betas = []

    def distance(ii, jj, beta=0.3):
        betas.append(beta)
        return dist[np.asarray(ii), np.asarray(jj)]

    video = SimpleNamespace(counter=n, stereo=stereo, distance=distance)
    got, want = [], []
    _graph(FactorGraph, video, max_factors, live, archived,
           got).add_proximity_factors(t0, t1, rad=rad, nms=nms, beta=beta,
                                      thresh=thresh, remove=remove)
    _graph(JFactorGraph, video, max_factors, live, archived,
           want).add_proximity_factors(t0, t1, rad=rad, nms=nms, beta=beta,
                                       thresh=thresh, remove=remove)
    assert got == want
    assert betas == [beta, beta]
    (ii, jj, rm), = got
    assert rm == remove
    # the scan took candidates beyond the near pairs and self-edges, and
    # stopped at the capacity where it binds
    near = sum(min(rad, i) * 2 + stereo for i in range(t0, n))
    assert len(ii) > near
    if case == "capacity":
        assert len(ii) > max_factors
