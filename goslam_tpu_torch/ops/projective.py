"""Pinhole + SE(3) reprojection and the frame-distance metric (PyTorch).

Points are homogeneous ``[X, Y, 1, d]`` with inverse depth ``d``
(disparity); poses are world-to-camera 7-vectors (see ops.lie).  Every
function works on a batch of edges ``(ii[e], jj[e])``.

The stereo convention is kept: an edge with ii == jj is a rectified
stereo pair whose relative transform is the fixed baseline
``t = [-0.1, 0, 0]``.
"""
from __future__ import annotations

import torch

from . import lie

# valid-mask threshold of the reprojection; the BA system build uses the
# stricter 0.25 (ops.dba.MIN_DEPTH)
MIN_DEPTH = 0.2

_STEREO_BASELINE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, device=None) -> torch.Tensor:
    """Pixel coordinate grid, [ht, wd, 2] as (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Inverse projection: disps [..., ht, wd] -> [..., ht, wd, 4]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, disps.device)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor,
         return_depth: bool = False) -> torch.Tensor:
    """Pinhole projection of homogeneous points [..., 4] -> pixel coords.

    Z below 0.5*MIN_DEPTH is replaced by 1 to keep the math finite;
    validity is the caller's mask."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    x = fx * (X / Z) + cx
    y = fy * (Y / Z) + cy
    if return_depth:
        return torch.stack([x, y, D / Z], dim=-1)
    return torch.stack([x, y], dim=-1)


def rel_poses(poses: torch.Tensor, ii: torch.Tensor,
              jj: torch.Tensor) -> torch.Tensor:
    """Per-edge G_ij = G_jj . G_ii^-1, the stereo baseline where ii == jj."""
    Gij = lie.rel(poses[ii], poses[jj])
    return torch.where((ii == jj)[:, None],
                       lie.constant(_STEREO_BASELINE, Gij), Gij)


def transform(poses: torch.Tensor, disps: torch.Tensor,
              intrinsics: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
              return_depth: bool = False):
    """Reproject the pixels of frames ii into frames jj.

    poses [T, 7], disps [T, ht, wd], intrinsics [4], ii/jj [E].
    Returns coords [E, ht, wd, 2] (3 with return_depth) and the valid
    mask [E, ht, wd] as float."""
    X0 = iproj(disps[ii], intrinsics)
    Gij = rel_poses(poses, ii, jj)
    X1 = lie.act(Gij[:, None, None, :], X0)
    coords = proj(X1, intrinsics, return_depth=return_depth)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)).to(
        coords.dtype)
    return coords, valid


def frame_distance(poses: torch.Tensor, disps: torch.Tensor,
                   intrinsics: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor, beta: float = 0.3) -> torch.Tensor:
    """Per-edge mean flow magnitude, [E]: beta mixes the full-SE3 flow with
    the translation-only flow; pairs with <75% valid pixels get 1000."""
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, disps.device)

    X0 = iproj(disps[ii], intrinsics)
    Gij = rel_poses(poses, ii, jj)
    X1 = lie.act(Gij[:, None, None, :], X0)
    coords_full = proj(X1, intrinsics)

    # translation-only flow (rotation removed)
    Gij_t = torch.cat([Gij[..., 0:3], torch.zeros_like(Gij[..., 3:6]),
                       torch.ones_like(Gij[..., 6:7])], dim=-1)
    X1_t = lie.act(Gij_t[:, None, None, :], X0)
    coords_t = proj(X1_t, intrinsics)

    valid = (X1[..., 2] > MIN_DEPTH) & (X1_t[..., 2] > MIN_DEPTH)
    dflow_full = torch.linalg.norm(coords_full - grid, dim=-1)
    dflow_t = torch.linalg.norm(coords_t - grid, dim=-1)
    d = beta * dflow_full + (1.0 - beta) * dflow_t

    vf = valid.to(d.dtype)
    num_valid = vf.sum(dim=(-2, -1))
    mean_d = (d * vf).sum(dim=(-2, -1)) / num_valid.clamp(min=1.0)
    enough = num_valid / float(ht * wd) > 0.75
    return torch.where(enough, mean_d, torch.full_like(mean_d, 1000.0))


# ---------------------------------------------------------------------------
# world points and multiview depth consistency (for the multiview filter)
# ---------------------------------------------------------------------------

# neighbour offsets of the depth-consistency check (droid_kernels.cu:695)
_NEIGHBOURS = (-1, -2, -3, 3, 4, 5)


def iproj_world(poses: torch.Tensor, disps: torch.Tensor,
                intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject each frame's disparity map into world coordinates.

    poses [T, 7] w2c, disps [T, ht, wd]; returns [T, ht, wd, 3]."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, disps.device)
    z = 1.0 / torch.clamp(disps, min=1e-8)
    X = z * (grid[..., 0] - cx) / fx
    Y = z * (grid[..., 1] - cy) / fy
    pts_cam = torch.stack([X, Y, z], dim=-1)
    c2w = lie.inv(poses)
    return lie.act3(c2w[:, None, None, :], pts_cam)


def depth_consistency_count(poses: torch.Tensor, disps: torch.Tensor,
                            intrinsics: torch.Tensor, thresh) -> torch.Tensor:
    """For every frame, how many of its 6 neighbours (offsets -1, -2, -3,
    +3, +4, +5) agree on each pixel's depth: neighbour j agrees at pixel p
    of frame i when p's warp into j has floor coordinates strictly inside
    the image and |1/d_warped - 1/d_j| < thresh at one of the 4 integer
    taps.  thresh: scalar or [T] (metres).  Returns [T, ht, wd] float."""
    T, ht, wd = disps.shape
    dev = disps.device
    offsets = torch.tensor(_NEIGHBOURS, device=dev)
    K = len(_NEIGHBOURS)
    ii = torch.arange(T, device=dev).repeat_interleave(K)
    jj = (ii.view(T, K) + offsets[None, :]).reshape(-1)
    in_range = (jj >= 0) & (jj < T)
    jj_c = jj.clamp(0, T - 1)

    coords = transform(poses, disps, intrinsics, ii, jj_c,
                       return_depth=True)[0]
    x, y, dz = coords.unbind(-1)                 # dz: inverse depth in j
    z = 1.0 / torch.clamp(dz, min=1e-8)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()

    t = torch.as_tensor(thresh, dtype=torch.float32, device=dev)
    t = t.expand(T)[ii][:, None, None]
    flat_dj = disps[jj_c].reshape(-1, ht * wd)
    agree = torch.zeros(x.shape, dtype=torch.bool, device=dev)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = (x0 + dx).clamp(0, wd - 1)
        yi = (y0 + dy).clamp(0, ht - 1)
        dj = torch.gather(flat_dj, 1, (yi * wd + xi).reshape(-1, ht * wd))
        zj = 1.0 / torch.clamp(dj.view(x.shape), min=1e-8)
        agree |= (z - zj).abs() < t

    inb = (x0 >= 0) & (x0 < wd - 1) & (y0 >= 0) & (y0 < ht - 1)
    ok = agree & inb & in_range[:, None, None]
    return ok.float().view(T, K, ht, wd).sum(dim=1)
