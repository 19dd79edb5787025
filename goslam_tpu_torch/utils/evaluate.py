"""Trajectory evaluation — ATE RMSE with SE(3)/Sim(3) Umeyama alignment
(evo's APE protocol on the translation part, correct_scale=True)."""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src/dst: [N, 3].  Returns (s, R [3,3], t [3]) with dst ~ s R src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12)) \
        if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_c2w: np.ndarray, gt_c2w: np.ndarray,
             correct_scale: bool = True):
    """Absolute trajectory error (translation RMSE) after Umeyama
    alignment.

    est_c2w/gt_c2w: [N, 4, 4].
    Returns dict with rmse/mean/median/std (metres) and the alignment.
    """
    p_est = est_c2w[:, :3, 3]
    p_gt = gt_c2w[:, :3, 3]

    # drop non-finite poses
    ok = np.isfinite(p_gt).all(axis=1) & np.isfinite(p_est).all(axis=1)
    p_est, p_gt = p_est[ok], p_gt[ok]

    s, R, t = umeyama(p_est, p_gt, with_scale=correct_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=1)
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n_poses": int(ok.sum()),
        "alignment": T,
        "scale": s,
    }



def write_tum_trajectory(path: str, timestamps: np.ndarray,
                         c2w: np.ndarray):
    """TUM/ETH3D submission format: `t tx ty tz qx qy qz qw` per line,
    timestamps at 9 decimals and pose entries at 14 (the benchmark
    servers' format)."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for t, m in zip(timestamps, c2w):
            q = Rotation.from_matrix(m[:3, :3]).as_quat()  # x y z w
            p = m[:3, 3]
            vals = " ".join(f"{x:.14f}" for x in
                            (p[0], p[1], p[2], q[0], q[1], q[2], q[3]))
            f.write(f"{t:.9f} {vals}\n")
