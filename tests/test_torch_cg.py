"""The port's PCG solver, its Schur matvec and the loop-mode edge proposal
against the JAX package, on the CPU.

  * ``dba.schur_matvec_plain`` (plain version of csrc/schur_matvec.cu) vs
    the Pallas kernel ``schur_matvec`` in interpret mode and the XLA
    expression of ``_cg_solve``;
  * ``dba.ba(solver="cg")`` vs the JAX package's, with the numbers of PCG
    iterations compared, and vs the port's own Cholesky path;
  * ``_inv6`` and ``_pcg`` on singular and non-finite systems;
  * ``Backend._propose_edges`` (the port's native scan, and its plain
    version ``propose_scan_plain`` in its place) vs the JAX package's
    Python and native scans; a failed build of the native scan raises;
  * ``FactorGraph.update_lowmem`` over 130 keyframes, where the window
    reaches 192 poses and the solver is PCG, in both packages.

Inputs are made with numpy from a seed and handed to both packages.  The
port's matvec carries Eij as bf16 on every device, as the TPU kernel does;
the JAX package does so only on its fused path (``fused=True``), which the
tests reach with the kernels patched to interpret mode.
"""
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goslam_tpu.ops.pallas_kernels as jpk
from goslam_tpu.ops import dba as jdba
from goslam_tpu.ops import lie as jlie
from goslam_tpu.ops import projective as jproj
from goslam_tpu.tracking.backend import Backend as JBackend
from goslam_tpu_torch import native
from goslam_tpu_torch.ops import dba
from goslam_tpu_torch.tracking import backend
from goslam_tpu_torch.tracking.backend import Backend


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several workers on one machine; PyTorch's default of
    one thread per core in each of them makes them all wait on each
    other.  Two threads per worker for this file, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the matvec
# ---------------------------------------------------------------------------

def _schur_graph(rng, kind):
    """Edge lists (ii, jj, valid) over P = 16 frames, at most 4 edges out
    of any frame.  "random": the problem of tests/test_pallas_kernels.py,
    degree 1-4 per frame, some edges invalid.  "hub": frame 0 receives 35
    edges, frame 5 has none, two edges are invalid and four padded slots
    with stale endpoints (the hub and frame 5 among them) close the list."""
    P, ii, jj = 16, [], []
    if kind == "random":
        for k in range(P):
            for j in rng.choice(P, rng.integers(1, 5), replace=False):
                ii.append(k)
                jj.append(int(j))
        valid = rng.random(len(ii)) > 0.15
        return np.asarray(ii), np.asarray(jj), valid, P
    others = [k for k in range(1, P) if k != 5]
    for k in others:
        for _ in range(2 + k % 2):
            ii.append(k)
            jj.append(0)
        ii.append(k)
        jj.append(int(rng.choice([f for f in others if f != k])))
    ii += [0, 0]
    jj += [1, 2]
    valid = np.ones(len(ii), bool)
    valid[[3, 17]] = False
    ii += [5, 0, 9, 5]
    jj += [0, 5, 5, 5]
    valid = np.append(valid, np.zeros(4, bool))
    return np.asarray(ii), np.asarray(jj), valid, P


@pytest.mark.parametrize("graph", ["random", "hub"])
def test_schur_plan_target_index(rng, graph):
    """schur_plan's second index, the scatter of the matvec to jj: every
    valid edge once, under its target frame, in source order; invalid
    edges nowhere; the edge order itself is the JAX plan's."""
    ii, jj, valid, P = _schur_graph(rng, graph)
    order = np.asarray(jpk.schur_matvec_plan(
        jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
        jnp.asarray(valid), P, 4, 8)[0])
    plan = dba.schur_plan(_t(ii), _t(jj), _t(valid), P)
    np.testing.assert_array_equal(plan.order.numpy(), order)
    jj_s, valid_s = jj[order], valid[order]
    rowptr, colptr = plan.rowptr.numpy(), plan.colptr.numpy()
    cidx = plan.cidx.numpy()
    assert plan.colptr.dtype == plan.cidx.dtype == torch.int32
    assert cidx.shape == (len(ii),)
    assert colptr[0] == 0 and colptr[P] == rowptr[P] == valid.sum()
    for j in range(P):
        want = [e for e in range(len(ii)) if valid_s[e] and jj_s[e] == j]
        np.testing.assert_array_equal(cidx[colptr[j]:colptr[j + 1]], want)
    assert sorted(cidx[:colptr[P]]) == list(np.flatnonzero(valid_s))
    if graph == "hub":
        assert colptr[1] - colptr[0] >= 30
        assert colptr[6] == colptr[5] and rowptr[6] == rowptr[5]


@pytest.mark.parametrize(
    "ref, graph", [("xla", "random"), ("pallas_interpret", "random"),
                   ("xla", "hub"), ("pallas_interpret", "hub")],
    ids=["xla", "pallas_interpret", "hub-xla", "hub-pallas_interpret"])
def test_schur_matvec_plain_matches_jax(rng, ref, graph):
    """On the graphs of _schur_graph, Eij rounded to bf16."""
    hw, fb, max_deg = 96, 8, 4
    ii, jj, valid, P = _schur_graph(rng, graph)
    ii, jj = ii.astype(np.int32), jj.astype(np.int32)
    E = len(ii)
    Eij = rng.standard_normal((E, 6, hw)).astype(np.float32)
    Ei = rng.standard_normal((P, 6, hw)).astype(np.float32)
    Q = rng.random((P, hw)).astype(np.float32)
    H = rng.standard_normal((E, 12, 12)).astype(np.float32)
    x = rng.standard_normal((P, 6)).astype(np.float32)

    order, cstart, onehot, jj_pad = jpk.schur_matvec_plan(
        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(valid), P, max_deg, fb)
    order = np.asarray(order)
    ii_s, jj_s, valid_s = ii[order], jj[order], valid[order]
    Eij_s = jnp.asarray(Eij[order] * valid_s[:, None, None]).astype(
        jnp.bfloat16).astype(jnp.float32)
    H_s = jnp.asarray(H[order] * valid_s[:, None, None])
    jx, jEi, jQ = jnp.asarray(x), jnp.asarray(Ei), jnp.asarray(Q)
    if ref == "xla":
        want = jnp.zeros((P, 6)).at[ii_s].add(
            jnp.einsum("eab,eb->ea", H_s[:, :6, :6], jx[ii_s])
            + jnp.einsum("eab,eb->ea", H_s[:, :6, 6:], jx[jj_s]))
        want = want.at[jj_s].add(
            jnp.einsum("eab,eb->ea", H_s[:, 6:, :6], jx[ii_s])
            + jnp.einsum("eab,eb->ea", H_s[:, 6:, 6:], jx[jj_s]))
        u = jnp.einsum("kah,ka->kh", jEi, jx)
        u = jQ * (u + jnp.zeros((P, hw)).at[ii_s].add(
            jnp.einsum("eah,ea->eh", Eij_s, jx[jj_s])))
        want = want - jnp.einsum("kah,kh->ka", jEi, u)
        want = want - jnp.zeros((P, 6)).at[jj_s].add(
            jnp.einsum("eah,eh->ea", Eij_s, u[ii_s]))
    else:
        packed = jpk.schur_pack(jEi, Eij_s, jQ, H_s)
        want = jpk.schur_matvec(jx, packed[0], packed[1], packed[2],
                                packed[3], jx[jj_s], cstart, onehot, jj_pad,
                                fb=fb, interpret=True)

    # the port's plan is the same stable sort; its matvec masks the
    # invalid edges itself, so they keep their (non-zero) H and Eij here
    plan = dba.schur_plan(_t(ii.astype(np.int64)), _t(jj.astype(np.int64)),
                          _t(valid), P)
    np.testing.assert_array_equal(plan.order.numpy(), order)
    o = plan.order
    got = dba.schur_matvec(_t(x), _t(Ei), _t(Q), _t(H)[o],
                           _t(Eij)[o].to(torch.bfloat16),
                           _t(jj)[o].contiguous(), plan.rowptr, plan.colptr,
                           plan.cidx, None)
    # fp32 sums over 96 pixels and up to 4 edges out of a frame in another
    # order, on entries of size ~30; the hub's row sums 35 edges' rows into
    # entries of ~2000: there 1e-6 of the largest entry
    want = np.asarray(want)
    atol = 1e-4 if graph == "random" else 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


# ---------------------------------------------------------------------------
# (b), (c) ba with the PCG solver
# ---------------------------------------------------------------------------

HT, WD = 8, 12
INTR = np.asarray([6.0, 6.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)


def _band_problem(seed, P=16, pad=4):
    """A chain of poses with edges between frames up to 3 apart (degree 6,
    E = 84 at P = 16: enough for the JAX package's fused matvec), one edge
    invalid and `pad` invalid slots with stale endpoints at the end."""
    rng = np.random.default_rng(seed)
    poses = [np.asarray(jlie.identity())]
    for _ in range(P - 1):
        xi = rng.normal(size=6).astype(np.float32) * 0.03
        poses.append(np.asarray(jlie.compose(jlie.exp(jnp.asarray(xi)),
                                             jnp.asarray(poses[-1]))))
    poses = np.stack(poses).astype(np.float32)
    disps = (0.6 + 0.15 * rng.random((P, HT, WD))).astype(np.float32)
    ii0, jj0 = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    keep = (ii0 != jj0) & (np.abs(ii0 - jj0) <= 3)
    ii, jj = ii0[keep], jj0[keep]
    valid = np.ones(len(ii), bool)
    valid[5] = False
    ii = np.append(ii, rng.integers(0, P, pad))
    jj = np.append(jj, rng.integers(0, P, pad))
    valid = np.append(valid, np.zeros(pad, bool))
    E = len(ii)
    coords, _ = jproj.transform(jnp.asarray(poses), jnp.asarray(disps),
                                jnp.asarray(INTR), jnp.asarray(ii),
                                jnp.asarray(jj))
    target = np.asarray(coords) + 0.3
    weight = rng.random((E, HT, WD, 2)).astype(np.float32)
    sens = np.where(rng.random((P, HT, WD)) < 0.5, disps, 0).astype(
        np.float32)
    eta = np.full((P, HT, WD), 1e-4, np.float32)
    return (poses, disps, INTR, sens, target, weight, eta,
            ii.astype(np.int64), jj.astype(np.int64), valid)


@contextlib.contextmanager
def _jax_pcg_iterations():
    """Collects the iteration count of every ``_pcg`` loop the JAX package
    runs inside the block: its ``while_loop`` is wrapped so that the
    final counter leaves the jitted program through a debug callback."""
    counts = []
    real = jax.lax.while_loop

    def spy(cond, body, init):
        out = real(cond, body, init)
        if isinstance(init, tuple) and len(init) == 6:     # _pcg's state
            jax.debug.callback(lambda k: counts.append(int(k)), out[0],
                               ordered=True)
        return out

    jax.lax.while_loop = spy
    jdba._ba_impl.clear_cache()
    try:
        yield counts
        jax.effects_barrier()
    finally:
        jax.lax.while_loop = real
        jdba._ba_impl.clear_cache()


@contextlib.contextmanager
def _port_pcg_iterations(monkeypatch):
    counts = []
    real = dba._pcg

    def spy(*a, **k):
        x, n = real(*a, **k)
        counts.append(n)
        return x, n

    monkeypatch.setattr(dba, "_pcg", spy)
    yield counts
    monkeypatch.setattr(dba, "_pcg", real)


@contextlib.contextmanager
def _jax_kernels_interpreted():
    """The JAX package's fused path on the CPU: its Pallas kernels in
    interpret mode (the patch of tests/test_dba.py)."""
    orig_b, orig_m = jpk.build_edge_system_fused, jpk.schur_matvec
    jpk.build_edge_system_fused = lambda *a, **k: orig_b(
        *a, **{**k, "interpret": True})
    jpk.schur_matvec = lambda *a, **k: orig_m(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        jpk.build_edge_system_fused, jpk.schur_matvec = orig_b, orig_m


def _jax_ba(prob, **kw):
    jargs = [jnp.asarray(a) for a in prob]
    jargs[7], jargs[8] = (jargs[7].astype(jnp.int32),
                          jargs[8].astype(jnp.int32))
    p, d = jdba.ba(*jargs, **kw)
    return np.asarray(p), np.asarray(d)


@pytest.mark.parametrize("motion_only", [False, True],
                         ids=["full", "motion_only"])
@pytest.mark.parametrize("iters", [1, 4])
def test_ba_cg_matches_jax_xla(monkeypatch, iters, motion_only):
    """Against the JAX package's XLA PCG (``fused=False``), which keeps
    Eij in fp32: in motion-only BA the two run the same arithmetic; in
    full BA the port's bf16 Eij perturbs the operator by ~0.4 %, which
    moves the solution of a Gauss-Newton step by that share of the step
    (a few 1e-4 here) and may cost or save a PCG iteration."""
    prob = _band_problem(7)
    kw = dict(t0=1, t1=16, iters=iters, max_deg=8, solver="cg", cg_iters=64,
              motion_only=motion_only, lm=1e-4, ep=0.1)
    with _jax_pcg_iterations() as jcounts:
        jp, jd = _jax_ba(prob, fused=False, **kw)
    with _port_pcg_iterations(monkeypatch) as counts:
        p, d = dba.ba(*[_t(a) for a in prob], **kw)
    assert len(counts) == len(jcounts) == iters
    if motion_only:
        assert counts == jcounts
        np.testing.assert_allclose(p.numpy(), jp, atol=2e-5)
        np.testing.assert_array_equal(d.numpy(), prob[1])
    else:
        assert all(abs(a - b) <= 1 for a, b in zip(counts, jcounts)), (
            counts, jcounts)
        np.testing.assert_allclose(p.numpy(), jp, atol=2e-3)
        np.testing.assert_allclose(d.numpy(), jd, atol=1e-2)
    assert all(0 < n <= 64 for n in counts)
    # the fixed pose does not move
    np.testing.assert_array_equal(p.numpy()[0], prob[0][0])


@pytest.mark.parametrize("iters", [1, 2])
def test_ba_cg_matches_jax_fused_interpret(monkeypatch, iters):
    """Against the JAX package's fused path (both Pallas kernels in
    interpret mode), which rounds Eij to bf16 as the port does: the same
    arithmetic up to summation order, and the same numbers of PCG
    iterations."""
    prob = _band_problem(7)
    kw = dict(t0=1, t1=16, iters=iters, max_deg=8, solver="cg", cg_iters=64)
    with _jax_kernels_interpreted(), _jax_pcg_iterations() as jcounts:
        jp, jd = _jax_ba(prob, fused=True, **kw)
    with _port_pcg_iterations(monkeypatch) as counts:
        p, d = dba.ba(*[_t(a) for a in prob], **kw)
    assert counts == jcounts and len(counts) == iters
    np.testing.assert_allclose(p.numpy(), jp, atol=2e-5)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-4, atol=2e-5)


def test_ba_cg_ignores_padded_edges():
    """Invalid slots with stale endpoints change nothing: dropping them
    gives the same answer."""
    prob = _band_problem(7, pad=6)
    keep = prob[9]
    trimmed = list(prob)
    for k in (4, 5, 7, 8, 9):
        trimmed[k] = prob[k][keep]
    kw = dict(t0=1, t1=16, iters=2, max_deg=8, solver="cg")
    p, d = dba.ba(*[_t(a) for a in prob], **kw)
    p2, d2 = dba.ba(*[_t(a) for a in trimmed], **kw)
    np.testing.assert_allclose(p2.numpy(), p.numpy(), atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), d.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("motion_only", [False, True],
                         ids=["full", "motion_only"])
def test_cg_matches_cholesky_in_the_port(motion_only):
    """tests/test_dba.py::test_cg_solver_matches_cholesky for the port:
    one-shot and after four Gauss-Newton steps the two solvers agree; the
    bound covers the PCG tolerance (1e-5 of |rhs|) and the bf16 Eij."""
    prob = _band_problem(3)
    args = [_t(a) for a in prob]
    for iters in (1, 4):
        kw = dict(t0=1, t1=16, iters=iters, max_deg=8,
                  motion_only=motion_only)
        p_ch, d_ch = dba.ba(*args, solver="chol", **kw)
        p_cg, d_cg = dba.ba(*args, solver="cg", cg_iters=64, **kw)
        np.testing.assert_allclose(p_cg.numpy(), p_ch.numpy(), atol=2e-3)
        np.testing.assert_allclose(d_cg.numpy(), d_ch.numpy(), atol=1e-2)


def test_unknown_solver_is_refused():
    with pytest.raises(ValueError, match="solver"):
        dba.ba(*[_t(a) for a in _band_problem(3)], t0=1, t1=16, max_deg=8,
               solver="lu")


# ---------------------------------------------------------------------------
# (d) failure semantics
# ---------------------------------------------------------------------------

def test_inv6_gives_identity_for_a_singular_or_non_finite_block(rng):
    A = rng.standard_normal((4, 6, 6)).astype(np.float32)
    blocks = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    blocks[1] = 0.0                       # singular
    blocks[2, 3, 3] = np.nan              # non-finite
    inv = dba._inv6(_t(blocks)).numpy()
    jinv = np.asarray(jdba._inv6(jnp.asarray(blocks)))
    np.testing.assert_array_equal(inv[1], np.eye(6))
    np.testing.assert_array_equal(inv[2], np.eye(6))
    np.testing.assert_allclose(inv, jinv, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(inv[0] @ blocks[0], np.eye(6), atol=1e-5)


def test_pcg_matches_jax_and_zeroes_a_non_finite_system(rng):
    """A seeded SPD block system: the same solution and iteration count
    as the JAX package's ``_pcg``; fixed poses stay zero; a non-finite
    right-hand side or operator gives zeros."""
    P = 10
    A = rng.standard_normal((6 * P, 6 * P))
    A = (A @ A.T / (6 * P) + np.eye(6 * P)).astype(np.float32)
    pm = np.ones(P, np.float32)
    pm[0] = 0
    pm6 = np.repeat(pm, 6)
    A = A * pm6[:, None] * pm6[None, :] + np.diag(1 - pm6)
    rhs = rng.standard_normal((P, 6)).astype(np.float32) * pm[:, None]
    blocks = np.stack([A[6 * k:6 * k + 6, 6 * k:6 * k + 6]
                       for k in range(P)])
    Minv = np.linalg.inv(blocks).astype(np.float32)

    tA = _t(A)
    x, n = dba._pcg(lambda v: (tA @ v.reshape(-1)).reshape(P, 6), _t(Minv),
                    _t(rhs), _t(pm), iters=64)
    jA = jnp.asarray(A)
    with jax.disable_jit(), _jax_pcg_iterations() as jcounts:
        jx = jdba._pcg(lambda v: (jA @ v.reshape(-1)).reshape(P, 6),
                       jnp.asarray(Minv), jnp.asarray(rhs), jnp.asarray(pm),
                       iters=64)
    assert [n] == jcounts and 0 < n < 64
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(A @ x.numpy().reshape(-1), rhs.reshape(-1),
                               atol=1e-4)
    assert not x[0].any()

    # the budget ends the loop where the tolerance does not
    _, n3 = dba._pcg(lambda v: (tA @ v.reshape(-1)).reshape(P, 6), _t(Minv),
                     _t(rhs), _t(pm), iters=3)
    assert n3 == 3

    bad = rhs.copy()
    bad[4, 2] = np.nan
    x, _ = dba._pcg(lambda v: (tA @ v.reshape(-1)).reshape(P, 6), _t(Minv),
                    _t(bad), _t(pm))
    assert not x.any()
    x, _ = dba._pcg(lambda v: v * float("inf"), _t(Minv), _t(rhs), _t(pm))
    assert not x.any()


# ---------------------------------------------------------------------------
# (e) loop-mode edge proposal
# ---------------------------------------------------------------------------

def _backends(dist):
    distance = lambda ii, jj, beta=0.3: dist[np.asarray(ii), np.asarray(jj)]
    jbe = JBackend.__new__(JBackend)
    jbe.video = SimpleNamespace(stereo=False, distance=distance)
    jbe.beta = 0.3
    be = Backend.__new__(Backend)
    be.video = SimpleNamespace(stereo=False, distance=distance)
    be.beta = 0.3
    be.last_loop_accepts = be.total_loop_accepts = 0
    return be, jbe


@pytest.mark.parametrize("impl", ["native", "python", "port_plain"])
@pytest.mark.parametrize("seed,loop", [(0, True), (1, True), (2, True),
                                       (3, False)])
def test_propose_edges_matches_jax(monkeypatch, seed, loop, impl):
    """The same distance matrix through both packages: the same edge list
    in the same order and the same number of accepted loop candidates.
    The port runs its native scan against the JAX package's native scan
    ("native") and its Python scan ("python"); "port_plain" runs the
    port's plain scan ``propose_scan_plain`` in place of its native one,
    against the JAX package's native scan.  The seeded matrix has a band
    of near revisits (frame k sees frame k - 30) so that the
    neighbourhood vote passes for some candidates and fails for
    others."""
    monkeypatch.setenv("GOSLAM_NATIVE_GREEDY",
                       "0" if impl == "python" else "1")
    if impl == "port_plain":
        monkeypatch.setattr(native, "greedy_propose",
                            backend.propose_scan_plain)
    rng = np.random.default_rng(seed)
    n = 48
    dist = 10.0 + 30.0 * rng.random((n, n))
    k = np.arange(n)
    for off in (29, 30, 31):
        band = np.abs(np.abs(k[:, None] - k[None, :]) - off) == 0
        dist[band] = 12.0 * rng.random(band.sum())
    dist = (dist + dist.T) / 2
    t_start, t_end = 0, n
    t_start_loop = n - 12 if loop else t_start
    existing = [(40, 39), (39, 40)] if loop else []
    be, jbe = _backends(dist)
    args = (t_start, t_end, t_start_loop, 1, 2, 14.0, 60, loop, existing)
    got = be._propose_edges(*args)
    want = jbe._propose_edges(*args)
    assert [(int(a), int(b)) for a, b in got] == \
        [(int(a), int(b)) for a, b in want]
    assert be.total_loop_accepts == jbe.total_loop_accepts
    assert be.last_loop_accepts == jbe.last_loop_accepts
    if loop:
        assert be.total_loop_accepts > 0
        assert any(abs(a - b) > 20 for a, b in got)


def test_native_scan_build_failure_raises(monkeypatch, tmp_path):
    """The port has no fallback to the Python scan: when the native scan
    cannot be built, edge proposal raises."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    be, _ = _backends(np.full((8, 8), 1.0))
    with pytest.raises(RuntimeError, match="building greedy.cpp failed"):
        be._propose_edges(0, 8, 0, 1, 1, 5.0, 20, False, [])
