"""Dense bundle adjustment of the port (ops/dba.py, Cholesky path)
against the JAX package's ``dba.ba`` on tests/test_dba.py-style problems.

A consistent synthetic scene (poses and disparities) is reprojected into
flow targets; both packages start from the same perturbed state, made
with numpy from a seed, and run the same Gauss-Newton steps in fp32.  The
tolerances cover summation order in the scatter-adds and the Schur
products, carried through a few iterations of a well-conditioned solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goslam_tpu.ops import dba as jdba
from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops import projective as jproj
from goslam_tpu_torch.ops import dba

HT, WD = 8, 12
INTR = np.asarray([6.0, 6.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(rng, P=5, stereo=False, pad=0):
    """Ground-truth scene, all-pairs edges (plus a stereo edge and `pad`
    invalid slots with stale endpoints), and a perturbed start."""
    xi = rng.normal(size=(P, 6)).astype(np.float32) * np.asarray(
        [0.04, 0.04, 0.04, 0.02, 0.02, 0.02], np.float32)
    xi[0] = 0
    gt = [np.asarray(jlie.identity())]
    for k in range(1, P):
        gt.append(np.asarray(jlie.compose(jlie.exp(jnp.asarray(xi[k])),
                                          jnp.asarray(gt[-1]))))
    gt = np.stack(gt).astype(np.float32)
    disps = (0.6 + 0.15 * rng.random((P, HT, WD))).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    keep = ii != jj
    ii, jj = ii[keep], jj[keep]
    if stereo:
        ii, jj = np.append(ii, 2), np.append(jj, 2)
    valid = np.ones(len(ii), bool)
    if pad:
        ii = np.append(ii, rng.integers(0, P, pad))
        jj = np.append(jj, rng.integers(0, P, pad))
        valid = np.append(valid, np.zeros(pad, bool))
    E = len(ii)
    target, _ = jproj.transform(jnp.asarray(gt), jnp.asarray(disps),
                                jnp.asarray(INTR), jnp.asarray(ii),
                                jnp.asarray(jj))
    target = np.asarray(target) + 0.05 * rng.standard_normal(
        (E, HT, WD, 2)).astype(np.float32)
    weight = rng.random((E, HT, WD, 2)).astype(np.float32)
    dxi = (rng.normal(size=(P, 6)) * 0.015).astype(np.float32)
    dxi[0] = 0
    poses0 = np.asarray(jlie.compose(jlie.exp(jnp.asarray(dxi)),
                                     jnp.asarray(gt)))
    disps0 = (disps * (1.0 + 0.1 * rng.standard_normal(
        (P, HT, WD)))).astype(np.float32)
    # sensor depth on most pixels: the RGB-D prior
    sens = np.where(rng.random((P, HT, WD)) < 0.8, disps, 0).astype(
        np.float32)
    eta = np.full((P, HT, WD), 1e-4, np.float32)
    return (poses0, disps0, INTR, sens, target, weight, eta,
            ii.astype(np.int64), jj.astype(np.int64), valid)


def _run_both(prob, **kw):
    jargs = [jnp.asarray(a) for a in prob]
    jargs[7], jargs[8] = jargs[7].astype(jnp.int32), jargs[8].astype(
        jnp.int32)
    jp, jd = jdba.ba(*jargs, **kw)
    p, d = dba.ba(*[_t(a) for a in prob], **kw)
    return (p.numpy(), d.numpy()), (np.asarray(jp), np.asarray(jd))


@pytest.mark.parametrize("case", [
    dict(motion_only=True, t0=1, t1=5, iters=4, lm=1e-5, ep=1e-4),
    dict(motion_only=False, t0=1, t1=5, iters=3, lm=1e-4, ep=0.1),
    dict(motion_only=False, t0=2, t1=4, iters=2, lm=1e-5, ep=1e-2),
], ids=["motion_only", "full", "partial_window"])
def test_ba_matches_jax(rng, case):
    prob = _problem(rng)
    (p, d), (jp, jd) = _run_both(prob, max_deg=8, **case)
    assert np.isfinite(p).all() and np.isfinite(d).all()
    np.testing.assert_allclose(p, jp, atol=2e-5)
    np.testing.assert_allclose(d, jd, rtol=1e-4, atol=1e-5)
    # fixed poses outside [t0, t1) do not move
    fixed = [k for k in range(5) if not case["t0"] <= k < case["t1"]]
    np.testing.assert_array_equal(p[fixed], prob[0][fixed])


def test_ba_stereo_and_padded_edges_match_jax(rng):
    """A stereo self-edge (depth only) and invalid slots whose stale
    endpoints must change nothing."""
    prob = _problem(rng, stereo=True, pad=6)
    (p, d), (jp, jd) = _run_both(prob, t0=1, t1=5, iters=2, max_deg=8)
    np.testing.assert_allclose(p, jp, atol=2e-5)
    np.testing.assert_allclose(d, jd, rtol=1e-4, atol=1e-5)
    # dropping the padding gives the same answer
    keep = prob[9]
    trimmed = list(prob)
    for k in (4, 5, 7, 8, 9):
        trimmed[k] = prob[k][keep]
    p2, d2 = dba.ba(*[_t(a) for a in trimmed], t0=1, t1=5, iters=2,
                    max_deg=8)
    np.testing.assert_allclose(p2.numpy(), p, atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), d, rtol=1e-6, atol=1e-6)


def test_ba_converges_toward_ground_truth(rng):
    """With noise-free targets of a known scene (the problem's start
    state, taken as the truth) and a perturbed start, the port's BA
    recovers the poses."""
    prob = list(_problem(rng))
    P = prob[0].shape[0]
    poses_gt, disps_gt = prob[0].copy(), prob[1].copy()
    tg, _ = jproj.transform(jnp.asarray(poses_gt), jnp.asarray(disps_gt),
                            jnp.asarray(INTR), jnp.asarray(prob[7]),
                            jnp.asarray(prob[8]))
    prob[4] = np.asarray(tg)
    prob[5] = np.ones_like(prob[5])
    prob[3] = disps_gt
    dxi = (rng.normal(size=(P, 6)) * 0.01).astype(np.float32)
    dxi[0] = 0
    prob[0] = np.asarray(jlie.compose(jlie.exp(jnp.asarray(dxi)),
                                      jnp.asarray(poses_gt)))
    err0 = np.abs(prob[0][:, :3] - poses_gt[:, :3]).max()
    p, _ = dba.ba(*[_t(a) for a in prob], t0=1, t1=P, iters=8, lm=1e-5,
                  ep=1e-4, max_deg=8)
    err1 = np.abs(p.numpy()[:, :3] - poses_gt[:, :3]).max()
    assert err1 < 0.05 * err0, (err0, err1)


def test_source_table_matches_jax_up_to_column_order(rng):
    """jnp.argsort is not stable, nor need torch.sort be: which same-source
    edge lands in which column may differ, and every use of the table
    sums over its columns.  So rows are compared as sets.  Edges past the
    capacity D are dropped (JAX: scatter into a spare row, mode="drop")
    and counted as overflow."""
    P, D = 6, 3
    ii = rng.integers(0, P, 40)
    valid = rng.random(40) < 0.7
    tbl, over = dba._source_table(_t(ii), _t(valid), P, D)
    jt, jover = jdba._source_table(jnp.asarray(ii, jnp.int32),
                                   jnp.asarray(valid), P, D)
    assert int(over) == int(jover)
    counts = np.bincount(ii[valid], minlength=P)
    assert int(over) == int(np.maximum(counts - D, 0).sum())
    for k in range(P):
        row = set(tbl[k].tolist()) - {-1}
        jrow = set(np.asarray(jt[k]).tolist()) - {-1}
        assert all(ii[e] == k and valid[e] for e in row | jrow)
        assert len(row) == len(jrow) == min(counts[k], D)
        if counts[k] <= D:
            # on an overflowing row the sort order decides which D edges
            # stay; elsewhere the rows hold the same edges
            assert row == jrow


def test_solve_spd_refines_and_zeroes_failures(rng):
    A = rng.standard_normal((12, 12))
    L = (A @ A.T + 12 * np.eye(12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    x = dba._solve_spd(_t(L), _t(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(L, b), rtol=1e-5,
                               atol=1e-6)
    # an indefinite matrix or a non-finite rhs gives dx = 0
    assert not dba._solve_spd(_t(-L), _t(b)).any()
    bad = b.copy()
    bad[3] = np.nan
    assert not dba._solve_spd(_t(L), _t(bad)).any()


def test_degree_check_and_overflow_poison(rng):
    """ba() refuses a degree over max_deg on the host; the Gauss-Newton
    loop itself poisons its outputs with NaN on a table overflow."""
    prob = [_t(a) for a in _problem(rng)]
    with pytest.raises(ValueError, match="max_deg"):
        dba.ba(*prob, t0=1, t1=5, max_deg=2)
    p, d = dba._ba_impl(*prob, 1, 5, 1, 1e-4, 0.1, False, 2)
    assert torch.isnan(p).all() and torch.isnan(d).all()


def test_cg_solver_is_not_ported(rng):
    prob = [_t(a) for a in _problem(rng)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dba.ba(*prob, t0=1, t1=5, max_deg=8, solver="cg")
