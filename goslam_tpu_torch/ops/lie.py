"""SE(3) group operations on quaternion-parameterized poses (PyTorch).

A pose is a 7-vector ``[tx, ty, tz, qx, qy, qz, qw]`` storing the rigid
transform ``X -> R(q) X + t`` (world-to-camera, as the keyframe buffer
keeps it).  Every function broadcasts over leading batch dimensions.
Homogeneous points are ``[x, y, z, h]`` with ``h`` the inverse-depth
weight: ``act(G, X)[:3] = R X[:3] + h t``.

Tangent vectors are 6-vectors ``[tau (trans), phi (rot)]``; ``retr``
applies a *left* increment ``G' = exp(xi) . G``.  The exponential and the
logarithm switch to Taylor expansions near zero rotation, so both stay
finite (and differentiable) at the identity.
"""
from __future__ import annotations

import torch

_EPS_TAYLOR = 1e-8  # theta^2 threshold below which Taylor expansions kick in


def identity(shape=(), device=None) -> torch.Tensor:
    """Identity pose(s) with the given leading batch shape."""
    p = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    p[..., 6] = 1.0
    return p


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a (x) b, quaternions as [qx, qy, qz, qw]."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (== inverse for unit quaternions)."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * uv + torch.linalg.cross(qv, uv, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def act(pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply pose to homogeneous point(s) [x,y,z,h]: [R x + h t, h]."""
    xyz = quat_rotate(pose[..., 3:7], X[..., :3]) + X[..., 3:4] * pose[..., 0:3]
    return torch.cat([xyz, X[..., 3:4]], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group composition G = Ga . Gb (first apply b, then a)."""
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    t = a[..., 0:3] + quat_rotate(a[..., 3:7], b[..., 0:3])
    return torch.cat([t, q], dim=-1)


def inv(pose: torch.Tensor) -> torch.Tensor:
    qinv = quat_inv(pose[..., 3:7])
    t = -quat_rotate(qinv, pose[..., 0:3])
    return torch.cat([t, qinv], dim=-1)


def rel(pose_i: torch.Tensor, pose_j: torch.Tensor) -> torch.Tensor:
    """Relative transform G_ij = G_j . G_i^-1 (frame-i to frame-j coords)."""
    qij = quat_mul(pose_j[..., 3:7], quat_inv(pose_i[..., 3:7]))
    tij = pose_j[..., 0:3] - quat_rotate(qij, pose_i[..., 0:3])
    return torch.cat([tij, qij], dim=-1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: 6-vector [tau, phi] -> pose (full V(phi) tau)."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    theta_sq = (phi * phi).sum(-1, keepdim=True)

    # the exact branch never sees theta_sq == 0 (sqrt'(0) = inf would leak
    # NaN gradients through the untaken branch)
    small = theta_sq < _EPS_TAYLOR
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)

    theta_p4 = theta_sq * theta_sq
    imag = torch.where(small, 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
                       torch.sin(0.5 * theta) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
                       torch.cos(0.5 * theta))
    q = torch.cat([imag * phi, real], dim=-1)

    # t = V(phi) tau with V = I + a [phi]_x + b [phi]_x^2
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta * safe_sq))
    c1 = torch.linalg.cross(phi, tau, dim=-1)
    c2 = torch.linalg.cross(phi, c1, dim=-1)
    t = tau + a * c1 + b * c2
    return torch.cat([t, q], dim=-1)


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: pose -> 6-vector [tau, phi]; inverse of exp."""
    q = pose[..., 3:7]
    t = pose[..., 0:3]
    # qw >= 0 keeps the rotation angle in [0, pi]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    qv = q[..., :3]
    qw = q[..., 3:4].clamp(-1.0, 1.0)
    nv_sq = (qv * qv).sum(-1, keepdim=True)
    small = nv_sq < 1e-12
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    theta = 2.0 * torch.atan2(torch.where(small, torch.zeros_like(nv), nv), qw)
    scale = torch.where(small, 2.0 + theta * theta / 12.0, theta / nv)
    phi = scale * qv

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small2 = theta_sq < _EPS_TAYLOR
    safe_sq = torch.where(small2, torch.ones_like(theta_sq), theta_sq)
    half_th = 0.5 * torch.sqrt(safe_sq)
    # V^{-1} = I - 1/2 [phi]_x + cc [phi]_x^2
    sin_h = torch.where(small2, torch.ones_like(half_th), torch.sin(half_th))
    cot_term = torch.where(
        small2, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_th * torch.cos(half_th) / sin_h) / safe_sq)
    c1 = torch.linalg.cross(phi, t, dim=-1)
    c2 = torch.linalg.cross(phi, c1, dim=-1)
    tau = t - 0.5 * c1 + cot_term * c2
    return torch.cat([tau, phi], dim=-1)


def retr(pose: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction G' = exp(xi) . G (left increment)."""
    return compose(exp(xi), pose)


def adjT(pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Dual adjoint transport of a 6-covector, Y = Adj(G)^T X:

      Y[:3] = R^T X[:3]
      Y[3:] = R^T X[3:] - R^T (t x X[:3])   (computed as R^T (X[:3] x t))
    """
    qinv = quat_inv(pose[..., 3:7])
    a = quat_rotate(qinv, X[..., 0:3])
    b = quat_rotate(qinv, X[..., 3:6])
    c = quat_rotate(qinv, torch.linalg.cross(X[..., 0:3], pose[..., 0:3],
                                             dim=-1))
    return torch.cat([a, b + c], dim=-1)


def matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose 7-vector -> 4x4 homogeneous matrix."""
    R = quat_to_matrix(pose[..., 3:7])
    t = pose[..., 0:3]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def normalize(pose: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion part."""
    q = pose[..., 3:7]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([pose[..., 0:3], q], dim=-1)


def interp(pose_a: torch.Tensor, pose_b: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation exp(w * log(Gb . Ga^-1)) . Ga."""
    dP = compose(pose_b, inv(pose_a))
    w = torch.as_tensor(w, dtype=pose_a.dtype, device=pose_a.device)[..., None]
    return compose(exp(w * log(dP)), pose_a)
