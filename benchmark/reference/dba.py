"""Dense bundle adjustment, plain: a frozen copy of the port's plain
edge system (``ops/dba.py::build_edge_system_plain``) and of its
Gauss-Newton loop with the damped dense Cholesky solve, without the
kernels and without PCG.

Constants: weights scaled by 0.001; MIN_DEPTH 0.25 zeroes weights; stereo
(ii == jj) edges constrain depth only; the RGB-D prior alpha 0.05 mixes
the sensor disparity in, eta damps pixels without sensor depth; damping
``ep + lm * diag`` on the reduced matrix; pose' = exp(dx) . pose,
disp' = max(disp + dz, 0.001).  Poses [t0, t1) are optimized.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie

MIN_DEPTH = 0.25
ALPHA_RGBD = 0.05
WEIGHT_SCALE = 0.001
DISP_MIN = 0.001

_STEREO_BASELINE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


class EdgeSystem(NamedTuple):
    """Per-edge normal-equation blocks (E edges, hw pixels)."""
    H: torch.Tensor      # [E, 12, 12] pose-pair Hessian ([Ji|Jj] basis)
    v: torch.Tensor      # [E, 12] rhs
    Eii: torch.Tensor    # [E, 6, hw] pose-i / depth-i coupling
    Eij: torch.Tensor    # [E, 6, hw] pose-j / depth-i coupling
    Cii: torch.Tensor    # [E, hw] depth-depth diagonal
    bz: torch.Tensor     # [E, hw] depth rhs


def _edge_transforms(poses, ii, jj):
    """Gij per edge with the stereo baseline, and the stereo flag."""
    Gij = lie.rel(poses[ii], poses[jj])
    stereo = ii == jj
    Gij = torch.where(stereo[:, None], Gij.new_tensor(_STEREO_BASELINE), Gij)
    return Gij, stereo


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
    Gij, stereo = _edge_transforms(poses, ii, jj)

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



def _dense_solve(rhs, L, pm_f, lm: float, ep: float):
    """Mask the assembled [6P*6P] reduced matrix L to the free poses, damp
    it with ``ep + lm * diag`` and solve; fixed poses get dx = 0."""
    P6 = rhs.numel()
    pm6 = pm_f.repeat_interleave(6)
    Lf = L.reshape(P6, P6) * pm6[:, None] * pm6[None, :]
    Lf = Lf + torch.diag((ep + lm * torch.diagonal(Lf)) * pm6 + (1.0 - pm6))
    return _solve_spd(Lf, rhs.reshape(P6) * pm6).reshape(-1, 6) \
        * pm_f[:, None]


def ba(poses, disps, intrinsics, disps_sens, target, weight, eta, ii,
       jj, valid, t0, t1, iters, lm, ep, motion_only=False):
    """`iters` Gauss-Newton steps over poses [P, 7] and disparities
    [P, ht, wd]; ii/jj [E] window-local, valid [E] bool.  Returns (poses,
    disps)."""
    P = poses.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    P6 = P * 6
    dev = poses.device
    f32 = torch.float32
    deg = torch.bincount(ii[valid], minlength=1)
    max_deg = max(int(deg.max()), 1)

    frames = torch.arange(P, device=dev)
    pose_mask = (frames >= t0) & (frames < t1)
    kx_mask = pose_mask | (torch.zeros(P, device=dev).index_add_(
        0, ii, valid.to(f32)) > 0)
    pm_f = pose_mask.to(f32)

    table, _ = _source_table(ii, valid, P, max_deg)
    tbl_ok = table >= 0
    tbl_idx = table.clamp(min=0)

    gi = pm_f[ii]
    gj = pm_f[jj]
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

    edge_system = build_edge_system_plain
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

    return poses, disps
