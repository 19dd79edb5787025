"""Synthetic RGB-D sequence — analytic room with procedural texture.

A dependency-free stand-in for the real benchmark datasets: a camera
orbits inside an axis-aligned box room whose walls carry a smooth 3D
procedural texture.  Color and depth are rendered analytically by
ray-box intersection, so ground-truth poses and depths are exact —
useful for end-to-end tests and demos without downloading datasets.
Items: (index, image [1, H_out, W_out, 3] float in [0, 1], depth
[H_out, W_out], intrinsics [4] (fx fy cx cy), gt c2w pose [4, 4]).
"""
from __future__ import annotations

import numpy as np



def _texture(p):
    """Smooth periodic 3D color field, [N, 3] -> [N, 3] in [0, 1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.5 * np.sin(3.1 * x + 1.7) * np.cos(2.3 * y)
    g = 0.5 + 0.5 * np.sin(2.7 * y + 0.3) * np.cos(1.9 * z)
    b = 0.5 + 0.5 * np.sin(2.1 * z + 2.9) * np.cos(2.9 * x)
    return np.stack([r, g, b], axis=-1)


def _ray_box_exit(o, d, half):
    """Distance to the box wall [-half, half]^3 from inside, per ray."""
    with np.errstate(divide="ignore"):
        t1 = (half - o[None, None, :]) / d
        t2 = (-half - o[None, None, :]) / d
    t = np.where(d > 0, t1, t2)
    t = np.where(np.abs(d) < 1e-9, np.inf, t)
    return t.min(axis=-1)


class Synthetic:
    def __init__(self, cfg):
        self.cfg = cfg
        self.H_out, self.W_out = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
        self.n_frames = cfg["data"].get("n_frames", 60)
        self.half = cfg["data"].get("room_half_size", 3.0)
        # fraction of a full orbit covered by the trajectory; 1.0 returns
        # the camera to its start pose (loop-closure scenarios)
        self.orbit = cfg["data"].get("orbit_fraction", 0.5)
        self.timestamps = np.arange(self.n_frames, dtype=np.float64)

        # circular path with small vertical bob, looking outward
        self.poses = []
        for k in range(self.n_frames):
            a = 2 * np.pi * k / self.n_frames * self.orbit
            c2w = np.eye(4, dtype=np.float32)
            # yaw rotation
            c2w[:3, :3] = np.asarray([
                [np.cos(a), 0, np.sin(a)],
                [0, 1, 0],
                [-np.sin(a), 0, np.cos(a)],
            ], np.float32)
            c2w[:3, 3] = [0.8 * np.sin(a), 0.2 * np.sin(3 * a),
                          0.8 * np.cos(a) - 0.5]
            self.poses.append(c2w)

    def __len__(self):
        return self.n_frames

    def gt_mesh(self, subdiv: int = 8):
        """Exact ground-truth room mesh: the interior surface of the
        [-half, half]^3 box, each face subdivided subdiv x subdiv for
        uniform surface sampling / stable ICP (mesh-eval protocol,
        reference mesher.py:390-421 — GO-SLAM evaluates against the
        dataset's GT mesh; here the scene geometry is analytic, so the
        GT mesh is too).  Returns (verts [V,3] float32, tris [T,3] int32)
        with triangles wound to face the room interior."""
        h = float(self.half)
        lin = np.linspace(-h, h, subdiv + 1, dtype=np.float32)
        verts, tris = [], []
        base = 0
        # each face: fixed axis + sign; (u, v) span the other two axes
        for axis in range(3):
            for sign in (-1.0, 1.0):
                u_ax, v_ax = [a for a in range(3) if a != axis]
                uu, vv = np.meshgrid(lin, lin, indexing="ij")
                pts = np.empty(uu.shape + (3,), np.float32)
                pts[..., axis] = sign * h
                pts[..., u_ax] = uu
                pts[..., v_ax] = vv
                verts.append(pts.reshape(-1, 3))
                n = subdiv + 1
                i0, j0 = np.meshgrid(np.arange(subdiv), np.arange(subdiv),
                                     indexing="ij")
                a = base + i0 * n + j0
                b, c, d = a + n, a + n + 1, a + 1
                tris.append(np.stack([a, b, c], -1).reshape(-1, 3))
                tris.append(np.stack([a, c, d], -1).reshape(-1, 3))
                base += pts.reshape(-1, 3).shape[0]
        verts = np.concatenate(verts).astype(np.float32)
        tris = np.concatenate(tris).astype(np.int32)
        # interior-facing winding (the grid orientation's handedness
        # flips with the axis permutation — fix per-face by checking the
        # normal against the room interior, i.e. the origin side)
        e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
        e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
        normal = np.cross(e1, e2)
        centroid = verts[tris].mean(axis=1)
        outward = (normal * centroid).sum(-1) > 0
        tris[outward] = tris[outward][:, [0, 2, 1]]
        return verts, tris

    def __getitem__(self, index):
        H, W = self.H_out, self.W_out
        # intrinsics chosen directly at output size
        fx = fy = 0.9 * W
        cx, cy = W / 2 - 0.5, H / 2 - 0.5
        intr = np.asarray([fx, fy, cx, cy], np.float32)

        c2w = self.poses[index]
        j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)],
                        axis=-1)
        dirs_w = dirs @ c2w[:3, :3].T
        o = c2w[:3, 3]

        t_exit = _ray_box_exit(o, dirs_w, self.half)
        pts = o[None, None, :] + dirs_w * t_exit[..., None]
        color = _texture(pts).astype(np.float32)
        depth = (t_exit * 1.0).astype(np.float32)  # z-depth = t (dirs z=1
        # in cam frame scaled) — use projective depth:
        depth = (t_exit * dirs[..., 2]).astype(np.float32)

        return index, color[None], depth, intr, c2w
