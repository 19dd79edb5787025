"""Pinhole reprojection over edges (a frozen copy of the port's plain
``ops/projective.py`` functions the reference needs).

Points are homogeneous ``[X, Y, 1, d]`` with inverse depth d; poses are
world-to-camera 7-vectors.  An edge with ii == jj is a rectified stereo
pair whose relative transform is the fixed baseline t = [-0.1, 0, 0].
"""
from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2
STEREO_BASELINE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, device=None) -> torch.Tensor:
    """[ht, wd, 2] as (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps, intrinsics):
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, disps.device)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs, intrinsics):
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z, _ = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    return torch.stack([fx * (X / Z) + cx, fy * (Y / Z) + cy], dim=-1)


def rel_poses(poses, ii, jj):
    Gij = lie.rel(poses[ii], poses[jj])
    base = Gij.new_tensor(STEREO_BASELINE)
    return torch.where((ii == jj)[:, None], base, Gij)


def transform(poses, disps, intrinsics, ii, jj):
    """Pixels of frames ii reprojected into frames jj: [E, ht, wd, 2]."""
    X0 = iproj(disps[ii], intrinsics)
    X1 = lie.act(rel_poses(poses, ii, jj)[:, None, None, :], X0)
    return proj(X1, intrinsics)
