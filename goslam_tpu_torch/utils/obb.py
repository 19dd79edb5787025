"""Oriented bounding box — PCA-based, dependency-free.

Replaces the reference's Open3D-backed OBB (oriented_bounding_box.py):
center/rotation/extent from a point cloud, point-in-box tests, AABB
conversion.
"""
from __future__ import annotations

import numpy as np


class OrientedBoundingBox:
    def __init__(self, center, R, extent):
        self.center = np.asarray(center, np.float32)
        self.R = np.asarray(R, np.float32)
        self.extent = np.asarray(extent, np.float32)

    @classmethod
    def from_points(cls, pts: np.ndarray, enlarge: float = 1.0,
                    extend: float = 0.0):
        """PCA box around the points (o3d uses the covariance eigenbasis
        too).  `extend` adds an absolute margin to every extent, matching
        the reference's compute_from_pointcloud(extend=...)
        (oriented_bounding_box.py:28-41)."""
        mu = pts.mean(0)
        x = pts - mu
        cov = x.T @ x / len(pts)
        w, V = np.linalg.eigh(cov)
        R = V[:, ::-1]                       # principal axes, major first
        if np.linalg.det(R) < 0:
            R[:, 2] *= -1
        local = x @ R
        lo, hi = local.min(0), local.max(0)
        center = mu + R @ ((lo + hi) / 2)
        extent = (hi - lo) * enlarge + extend
        return cls(center, R, extent)

    def contains(self, pts: np.ndarray) -> np.ndarray:
        local = (pts - self.center) @ self.R
        return (np.abs(local) <= self.extent / 2 + 1e-6).all(axis=1)

    def to_aabb(self) -> np.ndarray:
        """[3, 2] axis-aligned bound containing the OBB."""
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
             for sz in (-1, 1)], np.float32) * (self.extent / 2)
        world = corners @ self.R.T + self.center
        return np.stack([world.min(0), world.max(0)], axis=-1)
