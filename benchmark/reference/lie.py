"""SE(3) group operations on quaternion-parameterized poses: a frozen
copy of the functions of the port's plain ``ops/lie.py`` that the
reference needs, so that it imports nothing of the program.

A pose is a 7-vector ``[tx, ty, tz, qx, qy, qz, qw]`` storing the rigid
transform ``X -> R(q) X + t`` (world-to-camera, as the keyframe buffer
keeps it).  Every function broadcasts over leading batch dimensions.
Homogeneous points are ``[x, y, z, h]`` with ``h`` the inverse-depth
weight: ``act(G, X)[:3] = R X[:3] + h t``.

Tangent vectors are 6-vectors ``[tau (trans), phi (rot)]``; ``retr``
applies a *left* increment ``G' = exp(xi) . G``.  The exponential
switches to a Taylor expansion near zero rotation, so it stays finite
(and differentiable) at the identity.
"""
from __future__ import annotations

import torch

_EPS_TAYLOR = 1e-8  # theta^2 threshold below which Taylor expansions kick in


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


def act(pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply pose to homogeneous point(s) [x,y,z,h]: [R x + h t, h]."""
    xyz = quat_rotate(pose[..., 3:7], X[..., :3]) + X[..., 3:4] * pose[..., 0:3]
    return torch.cat([xyz, X[..., 3:4]], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group composition G = Ga . Gb (first apply b, then a)."""
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    t = a[..., 0:3] + quat_rotate(a[..., 3:7], b[..., 0:3])
    return torch.cat([t, q], dim=-1)


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


def retr(pose: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction G' = exp(xi) . G (left increment)."""
    return compose(exp(xi), pose)
