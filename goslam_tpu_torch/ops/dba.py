"""Dense bundle adjustment (DBA): Gauss-Newton over poses and disparities.

  * per-edge Jacobians and residuals -> ``build_edge_system``: on CUDA
    tensors the hand-written kernel ``csrc/edge_system.cu``, on CPU
    tensors its plain version ``build_edge_system_plain``;
  * the pose-pose blocks are scatter-added into a dense [6P, 6P] matrix;
  * the per-pixel depth block is diagonal, so the Schur complement
    E C^-1 E^T is formed from the diagonal, the pose-depth cross terms,
    and the same-source edge pairs of a degree-capped source table;
  * the reduced system is solved with a damped Cholesky (fp32 plus one
    refinement step), or, for large windows (``solver="cg"``), with
    matrix-free preconditioned conjugate gradients whose matvec is
    ``schur_matvec``: on CUDA tensors the hand-written kernel
    ``csrc/schur_matvec.cu``, on CPU tensors ``schur_matvec_plain``.  A
    failed or non-finite solve gives dx = 0.

Constants: weights scaled by 0.001; MIN_DEPTH 0.25 zeroes weights; stereo
(ii == jj) edges constrain depth only; the RGB-D prior alpha 0.05 mixes
the sensor disparity into C and the rhs, eta damps pixels without sensor
depth; damping ``ep + lm * diag`` on the reduced matrix; pose' =
exp(dx) . pose, disp' = max(disp + dz, 0.001).

Window poses [t0, t1) are optimized; disparities of those frames and of
every valid source frame ii are updated.

On CUDA ``index_add_`` sums with atomics in an order that changes from
run to run, so the scatter-adds below differ in their last bits between
runs, and the host's greedy edge proposal can turn such a flip into a
different edge set.  Runs on the card are compared by trajectory and
ATE, never bitwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace
from . import kernels, lie, projective

MIN_DEPTH = 0.25
ALPHA_RGBD = 0.05
WEIGHT_SCALE = 0.001
DISP_MIN = 0.001


class EdgeSystem(NamedTuple):
    """Per-edge normal-equation blocks (E edges, hw pixels)."""
    H: torch.Tensor      # [E, 12, 12] pose-pair Hessian ([Ji|Jj] basis)
    v: torch.Tensor      # [E, 12] rhs
    Eii: torch.Tensor    # [E, 6, hw] pose-i / depth-i coupling
    Eij: torch.Tensor    # [E, 6, hw] pose-j / depth-i coupling
    Cii: torch.Tensor    # [E, hw] depth-depth diagonal
    bz: torch.Tensor     # [E, hw] depth rhs


def _adjT_cols(pose, J):
    """Dual-adjoint transport in [E, 6, hw] layout (see lie.adjT):
    Y[:3] = R^T J[:3];  Y[3:] = R^T (J[3:] + J[:3] x t)."""
    q = lie.quat_inv(pose[:, 3:7])[:, :, None]
    t = pose[:, 0:3][:, :, None]
    qx, qy, qz, qw = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

    def rot(vx, vy, vz):
        ux = 2 * (qy * vz - qz * vy)
        uy = 2 * (qz * vx - qx * vz)
        uz = 2 * (qx * vy - qy * vx)
        return (vx + qw * ux + (qy * uz - qz * uy),
                vy + qw * uy + (qz * ux - qx * uz),
                vz + qw * uz + (qx * uy - qy * ux))

    a1, a2, a3, b1, b2, b3 = J.unbind(1)
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    r1, r2, r3 = rot(a1, a2, a3)
    s1, s2, s3 = rot(b1 + (a2 * tz - a3 * ty), b2 + (a3 * tx - a1 * tz),
                     b3 + (a1 * ty - a2 * tx))
    return torch.stack([r1, r2, r3, s1, s2, s3], dim=1)


def build_edge_system_plain(poses, disps, intrinsics, target, weight, ii, jj,
                            valid) -> EdgeSystem:
    """Plain version of the edge-system kernel: linearize the reprojection
    objective at every edge.

    poses [P, 7]; disps [P, ht, wd]; intrinsics [4]; target/weight
    [E, ht, wd, 2]; ii/jj [E] window-local frame indices; valid [E] bool.
    """
    E = ii.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    fx, fy, cx, cy = intrinsics.unbind(-1)
    dev = disps.device

    d_i = disps[ii].reshape(E, hw)
    u = torch.arange(wd, dtype=torch.float32, device=dev).repeat(ht)[None]
    v_pix = torch.arange(ht, dtype=torch.float32,
                         device=dev).repeat_interleave(wd)[None]
    Gij, stereo = projective.rel_poses(poses, ii, jj), ii == jj

    Xi = torch.stack([((u - cx) / fx).expand(E, hw),
                      ((v_pix - cy) / fy).expand(E, hw),
                      torch.ones_like(d_i), d_i], dim=-1)
    Xj = lie.act(Gij[:, None, :], Xi)
    x, y, z, h = Xj.unbind(-1)

    ok = z >= MIN_DEPTH
    d = torch.where(ok, 1.0 / torch.where(ok, z, torch.ones_like(z)),
                    torch.zeros_like(z))
    d2 = d * d

    tw = target.reshape(E, hw, 2)
    ww = weight.reshape(E, hw, 2) * WEIGHT_SCALE
    vf = valid.to(torch.float32)[:, None]
    zero = torch.zeros_like(d)
    wu = torch.where(ok, ww[..., 0], zero) * vf
    wv = torch.where(ok, ww[..., 1], zero) * vf
    ru = tw[..., 0] - (fx * d * x + cx)
    rv = tw[..., 1] - (fy * d * y + cy)

    # d(proj)/d(xi_j), left-increment tangent [trans, rot]: [E, 6, hw]
    Ju_j = fx * torch.stack([h * d, zero, -x * h * d2, -x * y * d2,
                             1.0 + x * x * d2, -y * d], dim=1)
    Jv_j = fy * torch.stack([zero, h * d, -y * h * d2, -1.0 - y * y * d2,
                             x * y * d2, x * d], dim=1)
    # d(proj)/d(disp_i)
    tij = Gij[:, 0:3]
    Jz_u = fx * (tij[:, 0:1] * d - tij[:, 2:3] * (x * d2))
    Jz_v = fy * (tij[:, 1:2] * d - tij[:, 2:3] * (y * d2))

    # depth blocks use the pre-stereo weights
    Cii = wu * Jz_u * Jz_u + wv * Jz_v * Jz_v
    bz = wu * ru * Jz_u + wv * rv * Jz_v

    # stereo edges do not constrain poses
    wu_p = torch.where(stereo[:, None], zero, wu)
    wv_p = torch.where(stereo[:, None], zero, wv)

    Ju_i = -_adjT_cols(Gij, Ju_j)
    Jv_i = -_adjT_cols(Gij, Jv_j)
    Jx_u = torch.cat([Ju_i, Ju_j], dim=1)          # [E, 12, hw]
    Jx_v = torch.cat([Jv_i, Jv_j], dim=1)

    H = (torch.einsum("eah,ebh->eab", Jx_u * wu_p[:, None], Jx_u)
         + torch.einsum("eah,ebh->eab", Jx_v * wv_p[:, None], Jx_v))
    vv = (torch.einsum("eah,eh->ea", Jx_u, wu_p * ru)
          + torch.einsum("eah,eh->ea", Jx_v, wv_p * rv))

    Eii = (wu_p * Jz_u)[:, None, :] * Ju_i + (wv_p * Jz_v)[:, None, :] * Jv_i
    Eij = (wu_p * Jz_u)[:, None, :] * Ju_j + (wv_p * Jz_v)[:, None, :] * Jv_j
    return EdgeSystem(H, vv, Eii, Eij, Cii, bz)


def build_edge_system(poses, disps, intrinsics, target, weight, ii, jj,
                      valid) -> EdgeSystem:
    """Edge system (see build_edge_system_plain): CUDA tensors launch the
    kernel csrc/edge_system.cu once on the raw arguments (Gij, the stereo
    baseline, the disparity gather and the valid mask are the kernel's own
    work), CPU tensors take the plain version.  On CUDA the call only
    checks, allocates and launches: it copies nothing from the host and
    reads nothing from the device, so it never synchronizes and can be
    captured in a CUDA graph.

    The kernel has no backward: its outputs are written through a raw
    pointer, so autograd would take them for constants and every
    gradient through BA would be zero.  A call that would launch it on
    inputs that require grad raises; differentiable callers ask ``ba``
    for ``fused=False``, the plain version."""
    if disps.device.type == "cpu":
        return build_edge_system_plain(poses, disps, intrinsics, target,
                                       weight, ii, jj, valid)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (poses, disps, intrinsics, target,
                                      weight)):
        raise ValueError("edge system: the kernel has no backward and its "
                         "inputs require grad; call dba.ba(..., "
                         "fused=False) to differentiate through BA")
    E, hw = check_edge_args(poses, disps, intrinsics, target, weight, ii,
                            jj, valid)
    sizes = (E * 144, E * 12, E * 6 * hw, E * 6 * hw, E * hw, E * hw)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=disps.device)
    out = EdgeSystem(*[part.view(shape) for part, shape in zip(
        buf.split(sizes), ((E, 12, 12), (E, 12), (E, 6, hw), (E, 6, hw),
                           (E, hw), (E, hw)))])
    kernels.edge_system(poses, disps, intrinsics, target, weight, ii, jj,
                        valid, *out)
    return out


def check_edge_args(poses, disps, intrinsics, target, weight, ii, jj,
                    valid):
    """Check the arguments of build_edge_system as the kernel reads them
    (from their metadata alone: nothing is read from the device): poses
    [P,7], disps [P,ht,wd], intrinsics [4], target/weight [E,ht,wd,2],
    all fp32; ii/jj [E] int64; valid [E] bool; all contiguous on one
    device.  Returns (E, hw)."""
    E = ii.shape[0]
    P, ht, wd = disps.shape if disps.dim() == 3 else (-1, -1, -1)
    dev = disps.device
    for name, t in (("poses", poses), ("disps", disps),
                    ("intrinsics", intrinsics), ("target", target),
                    ("weight", weight), ("ii", ii), ("jj", jj),
                    ("valid", valid)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"edge system: {name} must be contiguous on "
                             f"{dev}, got {t.device}")
    for name, t in (("poses", poses), ("disps", disps),
                    ("intrinsics", intrinsics), ("target", target),
                    ("weight", weight)):
        if t.dtype != torch.float32:
            raise ValueError(f"edge system: {name} must be fp32, got "
                             f"{t.dtype}")
    if (ii.dtype != torch.int64 or jj.dtype != torch.int64
            or valid.dtype != torch.bool):
        raise ValueError("edge system: ii/jj must be int64 and valid bool")
    if (P <= 0 or poses.shape != (P, 7) or ht * wd <= 0
            or target.shape != (E, ht, wd, 2)
            or weight.shape != (E, ht, wd, 2) or ii.shape != (E,)
            or jj.shape != (E,) or valid.shape != (E,)
            or intrinsics.shape != (4,)):
        raise ValueError("edge system: expected poses [P, 7], disps "
                         "[P, ht, wd], target/weight [E, ht, wd, 2], "
                         "ii/jj/valid [E] and intrinsics [4]")
    return E, ht * wd


def _source_table(ii, valid, P: int, D: int):
    """For each frame k the (up to D) edge indices with ii == k.

    Returns (table [P, D] int64 with -1 padding, overflow count).  Edges
    that rank past D are written into a spare row P that is cut off, the
    way JAX's scatter with mode="drop" discards them.  The sort need not
    be stable: it only permutes which same-source edge lands in which
    column, and every use of the table sums over the columns."""
    E = ii.shape[0]
    dev = ii.device
    key = torch.where(valid, ii, torch.full_like(ii, P))
    ks, order = torch.sort(key)
    starts = torch.searchsorted(ks, torch.arange(P + 1, device=dev))
    pos = torch.arange(E, device=dev) - starts[ks.clamp(0, P)]
    ok = (ks < P) & (pos < D)
    table = torch.full((P + 1, D), -1, dtype=torch.long, device=dev)
    table[torch.where(ok, ks, torch.full_like(ks, P)),
          torch.where(ok, pos, torch.zeros_like(pos))] = order
    overflow = ((ks < P) & (pos >= D)).sum()
    return table[:P], overflow


def _solve_spd(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Damped SPD solve: fp32 Cholesky plus one refinement step.  A failed
    factorization or a non-finite result gives zeros (no host sync)."""
    chol, info = torch.linalg.cholesky_ex(L)
    dx = torch.cholesky_solve(rhs[:, None], chol)
    r = rhs[:, None] - L @ dx
    dx = (dx + torch.cholesky_solve(r, chol))[:, 0]
    good = (info == 0) & torch.isfinite(dx).all()
    return torch.where(good, dx, torch.zeros_like(dx))


def _block_index(rows, cols, P6):
    """Flat [6P*6P] indices of the 6x6 blocks at block rows/cols [...]."""
    ar6 = torch.arange(6, device=rows.device)
    r = (rows[..., None] * 6 + ar6)[..., :, None]
    c = (cols[..., None] * 6 + ar6)[..., None, :]
    return r * P6 + c


def _inv6(blocks: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse; a singular or non-finite block gives the
    identity (``solve_ex`` reports a singular block where ``solve`` would
    raise on the CPU)."""
    eye = torch.eye(6, dtype=blocks.dtype, device=blocks.device)
    inv, info = torch.linalg.solve_ex(blocks, eye.expand_as(blocks))
    ok = (info == 0) & torch.isfinite(inv).all(dim=-1).all(dim=-1)
    return torch.where(ok[:, None, None], inv, eye)


def _pcg(matvec, Minv_blocks, rhs, pm_f, iters: int = 64, tol: float = 1e-5,
         x0=None):
    """Preconditioned conjugate gradients on the [P, 6] pose system.

    Minv_blocks [P, 6, 6] is the block-Jacobi preconditioner; fixed poses
    stay at zero through the pm_f masking inside matvec.  The loop ends
    early on the relative residual ``|r| <= tol |rhs|``, which the host
    reads once per iteration (one synchronize each).  x0 warm-starts the
    iteration.  Returns (x, iterations taken); a non-finite solution
    gives zeros."""
    def apply_M(r):
        return torch.einsum("kab,kb->ka", Minv_blocks, r)

    x = torch.zeros_like(rhs) if x0 is None else x0 * pm_f[:, None]
    r = rhs - matvec(x)
    z = apply_M(r)
    p = z
    rz = (r * z).sum()
    rhs_norm = torch.sqrt((rhs * rhs).sum()) + 1e-30
    k = 0
    while k < iters and bool(torch.sqrt((r * r).sum()) > tol * rhs_norm):
        Ap = matvec(p)
        alpha = rz / ((p * Ap).sum() + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = (r * z).sum()
        p = z + (rz_new / (rz + 1e-30)) * p
        rz = rz_new
        k += 1
    good = torch.isfinite(x).all()
    return torch.where(good, x, torch.zeros_like(x)) * pm_f[:, None], k


class SchurPlan(NamedTuple):
    """Edge order of ``schur_matvec``, made once per ``ba`` call."""
    order: torch.Tensor     # [E] permutation: by source frame, invalid last
    rowptr: torch.Tensor    # [P + 1] int32: frame k owns rowptr[k:k+2]
    colptr: torch.Tensor    # [P + 1] int32: edges into j at colptr[j:j+2]
    cidx: torch.Tensor      # [E] int32: positions in `order` of the valid
                            # edges by target frame; past colptr[P] unused


def schur_plan(ii, jj, valid, P: int) -> SchurPlan:
    """Sort the edges by source frame (stable, so the plan is the same on
    every device), invalid edges past the end where nothing visits them;
    then list the valid ones again by target frame (stable), for the
    matvec's scatter to jj without atomics."""
    key = torch.where(valid, ii, torch.full_like(ii, P))
    ks, order = torch.sort(key, stable=True)
    frames = torch.arange(P + 1, device=ii.device)
    rowptr = torch.searchsorted(ks, frames)
    tkey = torch.where(valid[order], jj[order], torch.full_like(jj, P))
    tks, cidx = torch.sort(tkey, stable=True)
    colptr = torch.searchsorted(tks, frames)
    return SchurPlan(order, rowptr.to(torch.int32), colptr.to(torch.int32),
                     cidx.to(torch.int32))


def schur_matvec_plain(x, Ei, Q, H, Eij, jj, rowptr) -> torch.Tensor:
    """Plain version of the Schur-matvec kernel: y = (A - E Q E^T) x,
    damping excluded.

    x [P, 6]; Ei [P, 6, hw]; Q [P, hw]; H [E, 12, 12] pose-pair Hessians
    in the [x_i | x_j] basis; Eij [E, 6, hw] bf16 (summed in fp32); jj [E]
    and rowptr [P + 1] of edges sorted by source frame (``schur_plan``).
    Edges at or past rowptr[P] are invalid and contribute nothing."""
    P, E = Ei.shape[0], Eij.shape[0]
    e = torch.arange(E, device=x.device)
    rp = rowptr.long()
    ok = (e < rp[P])[:, None, None]
    ii = torch.searchsorted(rp[1:], e, right=True).clamp(max=P - 1)
    jj = jj.long()
    G = torch.where(ok, Eij.float(), torch.zeros((), device=x.device))
    Hm = torch.where(ok, H, torch.zeros((), device=x.device))
    xj = x[jj]
    hy = torch.einsum("eab,eb->ea", Hm, torch.cat([x[ii], xj], dim=1))
    u = torch.einsum("kah,ka->kh", Ei, x)
    u = Q * u.index_add(0, ii, torch.einsum("eah,ea->eh", G, xj))
    y = -torch.einsum("kah,kh->ka", Ei, u)
    y = y.index_add(0, ii, hy[:, :6])
    return y.index_add(0, jj, hy[:, 6:]
                       - torch.einsum("eah,eh->ea", G, u[ii]))


class SchurWork(NamedTuple):
    """What the Schur-matvec kernel writes, made once per Gauss-Newton
    step and reused by every matvec of its PCG solve.  ``schur_matvec``
    returns ``y`` itself: the next call with the same work overwrites
    it, so a caller uses the result before that call or copies it."""
    yf: torch.Tensor        # [P, 6] each source frame's own rows
    oc: torch.Tensor        # [E, 6] each edge's rows for its target frame
    y: torch.Tensor         # [P, 6] the result


def schur_work(P: int, E: int, device) -> SchurWork:
    return SchurWork(*[torch.empty(shape, dtype=torch.float32, device=device)
                       for shape in ((P, 6), (E, 6), (P, 6))])


def schur_matvec(x, Ei, Q, H, Eij, jj, rowptr, colptr, cidx,
                 work: SchurWork | None) -> torch.Tensor:
    """One matvec of the reduced camera system (see schur_matvec_plain;
    colptr/cidx are ``schur_plan``'s target index).  CUDA tensors launch
    the kernel csrc/schur_matvec.cu once, scatter to jj included, into
    ``work`` (``schur_work``), and return ``work.y``; CPU tensors take the
    plain version and need no work."""
    if x.device.type == "cpu":
        return schur_matvec_plain(x, Ei, Q, H, Eij, jj, rowptr)
    if work is None:
        raise ValueError("schur matvec: a CUDA matvec writes into "
                         "work=schur_work(P, E, device)")
    P, _, hw = Ei.shape
    E = Eij.shape[0]
    for name, t, shape, dtype in (
            ("x", x, (P, 6), torch.float32), ("Ei", Ei, (P, 6, hw),
                                              torch.float32),
            ("Q", Q, (P, hw), torch.float32),
            ("H", H, (E, 12, 12), torch.float32),
            ("Eij", Eij, (E, 6, hw), torch.bfloat16),
            ("jj", jj, (E,), torch.int32),
            ("rowptr", rowptr, (P + 1,), torch.int32),
            ("colptr", colptr, (P + 1,), torch.int32),
            ("cidx", cidx, (E,), torch.int32),
            ("yf", work.yf, (P, 6), torch.float32),
            ("oc", work.oc, (E, 6), torch.float32),
            ("y", work.y, (P, 6), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(
                f"schur matvec: {name} must be contiguous {dtype} "
                f"{list(shape)} on {x.device}, got {t.dtype} "
                f"{list(t.shape)} on {t.device}")
    if H.data_ptr() % 16:
        raise ValueError("schur matvec: H must be 16-byte aligned")
    kernels.schur_matvec(x, Ei, Q, H, Eij, jj, rowptr, colptr, cidx, *work)
    return work.y


def _cg_solve(rhs, Hblocks, Ei, Eij_m, Q, ii, jj, pm_f, lm: float,
              ep: float, cg_iters: int, plan, x0):
    """Matrix-free PCG on the reduced system: block-Jacobi preconditioner
    ``Dg + diag(ep + lm diag(Dg))`` (identity on fixed poses), damping
    applied outside the matvec.  ``plan`` is (jj int32, rowptr, colptr,
    cidx) of the sorted edges, or None for motion-only BA, whose matvec is
    the pose-Hessian part alone.  Returns (dx, iterations taken)."""
    Hii, Hij, Hji, Hjj = Hblocks
    P = rhs.shape[0]
    eye6 = torch.eye(6, dtype=rhs.dtype, device=rhs.device)

    Dg = torch.zeros((P, 6, 6), dtype=rhs.dtype, device=rhs.device)
    Dg.index_add_(0, ii, Hii)
    Dg.index_add_(0, jj, Hjj)
    if plan is not None:
        Dg = Dg - torch.einsum("kah,kbh->kab", Ei * Q[:, None], Ei)
        Dg.index_add_(0, jj, -torch.einsum(
            "eah,ebh->eab", Eij_m * Q[ii][:, None], Eij_m))

    damp = ep + lm * torch.diagonal(Dg, dim1=-2, dim2=-1)         # [P, 6]
    Mb = Dg + torch.diag_embed(damp)
    Mb = Mb * pm_f[:, None, None] + eye6 * (1 - pm_f)[:, None, None]
    Minv = _inv6(Mb)

    if plan is not None:
        # the operands of the matvec and the kernel's scratch, made once
        # per Gauss-Newton step; Eij travels as bf16 as in the TPU kernel
        jj32, rowptr, colptr, cidx = plan
        Hm = torch.cat([torch.cat([Hii, Hij], dim=2),
                        torch.cat([Hji, Hjj], dim=2)], dim=1).contiguous()
        Eij_k = Eij_m.to(torch.bfloat16).contiguous()
        Ei_k, Q_k = Ei.contiguous(), Q.contiguous()
        work = None if rhs.device.type == "cpu" else schur_work(
            P, Eij_k.shape[0], rhs.device)

    def matvec(x):
        xm = x * pm_f[:, None]
        if plan is not None:
            yA = schur_matvec(xm, Ei_k, Q_k, Hm, Eij_k, jj32, rowptr,
                              colptr, cidx, work)
        else:
            xi, xj = xm[ii], xm[jj]
            yA = torch.zeros_like(xm)
            yA.index_add_(0, ii, torch.einsum("eab,eb->ea", Hii, xi)
                          + torch.einsum("eab,eb->ea", Hij, xj))
            yA.index_add_(0, jj, torch.einsum("eab,eb->ea", Hji, xi)
                          + torch.einsum("eab,eb->ea", Hjj, xj))
        y = (yA + damp * xm) * pm_f[:, None]
        return y + x * (1 - pm_f)[:, None]

    return _pcg(matvec, Minv, rhs * pm_f[:, None], pm_f, cg_iters, x0=x0)


def ba(poses, disps, intrinsics, disps_sens, target, weight, eta, ii, jj,
       valid, t0, t1, iters: int = 2, lm: float = 1e-4,
       ep: float = 0.1, motion_only: bool = False, max_deg: int = 24,
       solver: str = "chol", cg_iters: int = 64,
       fused: bool | None = None, deg: int | None = None):
    """Run `iters` Gauss-Newton steps of dense bundle adjustment.

    poses [P, 7]; disps/disps_sens/eta [P, ht, wd]; target/weight
    [E, ht, wd, 2]; ii/jj [E] window-local; valid [E] bool.  Poses in
    [t0, t1) are optimized; t0 and t1 are ints or 0-d integer tensors on
    the device (a CUDA graph's inputs).  ``solver`` is "chol" (dense
    damped Cholesky) or "cg" (matrix-free PCG, at most ``cg_iters``
    iterations per Gauss-Newton step).  ``fused`` picks the edge system:
    None the device's (``build_edge_system``: the kernel on CUDA, the
    plain version on the CPU), False the plain version on every device,
    which autograd differentiates (the trainer's choice).  Returns
    (poses, disps).

    The per-source edge degree must fit the table capacity max_deg: it is
    checked here on the host (callers bucket max_deg from the true
    degree).  ``deg`` is that degree (the most valid edges of one source
    frame in ii) where the caller has it on the host, as the factor
    graph does; without it the check reads the device, a synchronize.
    ``_ba_impl`` itself poisons its outputs with NaN on a table overflow.
    """
    if solver not in ("chol", "cg"):
        raise ValueError(f"solver must be 'chol' or 'cg', got {solver!r}")
    if fused not in (None, False):
        raise ValueError(f"fused must be None or False, got {fused!r}")
    if deg is None and bool(valid.any()):
        deg = int(torch.bincount(ii[valid]).max())
    if deg is not None and deg > max_deg:
        raise ValueError(
            f"per-source edge degree {deg} exceeds the table capacity "
            f"max_deg={max_deg}; bucket max_deg from the true degree "
            f"(utils.shapes.bucket) before calling ba()")
    return _ba_impl(poses, disps, intrinsics, disps_sens, target, weight,
                    eta, ii, jj, valid, t0, t1, iters, lm, ep, motion_only,
                    max_deg, solver, cg_iters, fused)


def _dense_solve(rhs, L, pm_f, lm: float, ep: float):
    """Mask the assembled [6P*6P] reduced matrix L to the free poses, damp
    it with ``ep + lm * diag`` and solve; fixed poses get dx = 0."""
    P6 = rhs.numel()
    pm6 = pm_f.repeat_interleave(6)
    Lf = L.reshape(P6, P6) * pm6[:, None] * pm6[None, :]
    Lf = Lf + torch.diag((ep + lm * torch.diagonal(Lf)) * pm6 + (1.0 - pm6))
    return _solve_spd(Lf, rhs.reshape(P6) * pm6).reshape(-1, 6) \
        * pm_f[:, None]


def _ba_impl(poses, disps, intrinsics, disps_sens, target, weight, eta, ii,
             jj, valid, t0, t1, iters, lm, ep, motion_only, max_deg,
             solver="chol", cg_iters=64, fused=None):
    """The Gauss-Newton loop of ``ba`` without the host degree check."""
    P = poses.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    P6 = P * 6
    dev = poses.device
    f32 = torch.float32
    cg = solver == "cg"

    # the PCG matvec walks the edges frame by frame: sort them by source
    # frame once, so that every per-edge array below comes out sorted (the
    # permutation only reorders sums)
    plan = None
    if cg and not motion_only:
        order, rowptr, colptr, cidx = schur_plan(ii, jj, valid, P)
        ii, jj, valid = ii[order], jj[order], valid[order]
        target, weight = target[order], weight[order]
        plan = (jj.to(torch.int32), rowptr, colptr, cidx)

    frames = torch.arange(P, device=dev)
    pose_mask = (frames >= t0) & (frames < t1)
    kx_mask = pose_mask | (torch.zeros(P, device=dev).index_add_(
        0, ii, valid.to(f32)) > 0)
    pm_f = pose_mask.to(f32)

    table, overflow = _source_table(ii, valid, P, max_deg)
    tbl_ok = table >= 0
    tbl_idx = table.clamp(min=0)

    gi = pm_f[ii]
    gj = pm_f[jj]
    if not cg:
        idx_ii = _block_index(ii, ii, P6).reshape(-1)
        idx_ij = _block_index(ii, jj, P6).reshape(-1)
        idx_ji = _block_index(jj, ii, P6).reshape(-1)
        idx_jj = _block_index(jj, jj, P6).reshape(-1)

    def assemble(Hii, Hij, Hji, Hjj, Ei, Eij_m, Q):
        """The reduced matrix as a flat [6P*6P] array: the pose-pair blocks
        minus the Schur complement E Q E^T."""
        L = torch.zeros(P6 * P6, dtype=f32, device=dev)
        L.index_add_(0, idx_ii, Hii.reshape(-1))
        L.index_add_(0, idx_ij, Hij.reshape(-1))
        L.index_add_(0, idx_ji, Hji.reshape(-1))
        L.index_add_(0, idx_jj, Hjj.reshape(-1))
        if motion_only:
            return L
        Skk = torch.einsum("kah,kbh->kab", Ei * Q[:, None], Ei)
        L.index_add_(0, _block_index(frames, frames, P6).reshape(-1),
                     -Skk.reshape(-1))
        Sx = torch.einsum("eah,ebh->eab", Ei[ii] * Q[ii][:, None], Eij_m)
        L.index_add_(0, idx_ij, -Sx.reshape(-1))
        L.index_add_(0, idx_ji, -Sx.transpose(-1, -2).reshape(-1))
        # (jj_e1, jj_e2) pairs of edges with the same source frame
        G = Eij_m[tbl_idx] * tbl_ok[..., None, None]        # [P,D,6,hw]
        Spp = torch.einsum("kdah,kebh->kdeab", G * Q[:, None, None], G)
        pj = jj[tbl_idx]
        okrc = (tbl_ok[:, :, None] & tbl_ok[:, None, :]).to(f32)
        L.index_add_(0, _block_index(pj[:, :, None], pj[:, None, :],
                                     P6).reshape(-1),
                     (-Spp * okrc[..., None, None]).reshape(-1))
        return L

    edge_system = build_edge_system_plain if fused is False \
        else build_edge_system
    dx = None       # the PCG warm start: the previous step's solution
    for _ in range(iters):
        sys = edge_system(poses, disps, intrinsics, target, weight, ii, jj,
                          valid)
        Hii = sys.H[:, :6, :6] * gi[:, None, None]
        Hij = sys.H[:, :6, 6:] * (gi * gj)[:, None, None]
        Hji = sys.H[:, 6:, :6] * (gj * gi)[:, None, None]
        Hjj = sys.H[:, 6:, 6:] * gj[:, None, None]

        b = torch.zeros((P, 6), dtype=f32, device=dev)
        b.index_add_(0, ii, sys.v[:, :6] * gi[:, None])
        b.index_add_(0, jj, sys.v[:, 6:] * gj[:, None])

        if motion_only:
            Q = Ei = Eij_m = None
            rhs = b
        else:
            disps_flat = disps.reshape(P, hw)
            sens_flat = disps_sens.reshape(P, hw)
            m = (sens_flat > 0).to(f32)
            Cacc = torch.zeros((P, hw), dtype=f32, device=dev).index_add_(
                0, ii, sys.Cii)
            C = Cacc + m * ALPHA_RGBD + (1.0 - m) * eta.reshape(P, hw)
            w_rhs = torch.zeros((P, hw), dtype=f32, device=dev).index_add_(
                0, ii, sys.bz)
            w_rhs = w_rhs - m * ALPHA_RGBD * (disps_flat - sens_flat)
            Q = kx_mask[:, None].to(f32) / C.clamp(min=1e-12)

            # Ei: the depth-k rows attached to pose k (when pose k is free)
            Ei = torch.zeros((P, 6, hw), dtype=f32, device=dev).index_add_(
                0, ii, sys.Eii) * pm_f[:, None, None]
            Eij_m = sys.Eij * gj[:, None, None]

            # rhs reduction v - E Q w
            bs = torch.einsum("kah,kh->ka", Ei, Q * w_rhs)
            bx = torch.einsum("eah,eh->ea", Eij_m, (Q * w_rhs)[ii])
            rhs = b - bs - torch.zeros((P, 6), dtype=f32,
                                       device=dev).index_add_(0, jj, bx)

        if cg:
            dx, k = _cg_solve(rhs, (Hii, Hij, Hji, Hjj), Ei, Eij_m, Q, ii,
                              jj, pm_f, lm, ep, cg_iters, plan, dx)
            trace.add("pcg.solves")
            trace.add("pcg.iters", k)
        else:
            dx = _dense_solve(rhs, assemble(Hii, Hij, Hji, Hjj, Ei, Eij_m, Q),
                              pm_f, lm, ep)
        poses = lie.retr(poses, dx)

        if not motion_only:
            # depth back-substitution dz = Q (w - E^T dx)
            dw = torch.einsum("kah,ka->kh", Ei, dx)
            dw = dw.index_add(0, ii, torch.einsum("eah,ea->eh", Eij_m,
                                                  dx[jj]))
            dz = Q * (w_rhs - dw)
            disps = (disps + dz.reshape(P, ht, wd)).clamp(min=DISP_MIN)

    # an overflow of the degree-capped table would silently drop edges:
    # poison the outputs so every finiteness check trips
    bad = overflow > 0
    nan = torch.full((), float("nan"), device=dev)
    return torch.where(bad, nan, poses), torch.where(bad, nan, disps)
