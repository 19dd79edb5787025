"""Offline mesh-video renderer: every mesh of a run with its trajectory.

    python -m goslam_tpu_torch.tools.meshvideo output/run --fps 10

renders each ``mesh/*.ply`` of the run directory (a ``--make_video`` run
writes one after every mapping round, then the final meshes) with the
trajectory from ``est_poses.npy`` up to that mesh, with matplotlib's 3D
projection, and assembles the frames into ``mesh_video.mp4`` with
OpenCV.  A host-side tool: matplotlib and OpenCV are imported inside the
functions.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def render_frame(verts, tris, traj, out_path, elev=-60, azim=-90):
    """One frame: up to 30,000 of the mesh's triangles and the
    trajectory traj [N, 3] (its last position marked), as a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    if len(tris):
        sel = np.random.default_rng(0).choice(
            len(tris), min(len(tris), 30000), replace=False)
        ax.plot_trisurf(verts[:, 0], verts[:, 1], verts[:, 2],
                        triangles=tris[sel], linewidth=0, alpha=0.8,
                        color="lightsteelblue")
    if traj is not None and len(traj):
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "r-", linewidth=2)
        ax.scatter(*traj[-1], color="red", s=30)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def make_video(run_dir: str, fps: int = 10) -> str | None:
    """Render every mesh/*.ply of run_dir, in name order, with the growing
    trajectory (frames under video_frames/) into mesh_video.mp4.  Returns
    the video's path, or None when the run has no mesh."""
    from ..mapping.mesher import load_ply

    meshes = sorted(glob.glob(os.path.join(run_dir, "mesh", "*.ply")))
    traj_file = os.path.join(run_dir, "est_poses.npy")
    traj = np.load(traj_file)[:, :3, 3] if os.path.exists(traj_file) else None

    frame_dir = os.path.join(run_dir, "video_frames")
    os.makedirs(frame_dir, exist_ok=True)
    paths = []
    for k, mp in enumerate(meshes):
        v, t = load_ply(mp)
        sub = traj[: (k + 1) * max(1, (len(traj) // max(len(meshes), 1)))] \
            if traj is not None else None
        fp = os.path.join(frame_dir, f"{k:05d}.png")
        render_frame(v, t, sub, fp)
        paths.append(fp)

    if not paths:
        return None
    import cv2
    h, w = cv2.imread(paths[0]).shape[:2]
    out = os.path.join(run_dir, "mesh_video.mp4")
    vw = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in paths:
        vw.write(cv2.imread(p))
    vw.release()
    print(f"wrote {len(paths)} frames -> mesh_video.mp4")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--fps", type=int, default=10)
    args = ap.parse_args(argv)
    make_video(args.run_dir, args.fps)


if __name__ == "__main__":
    main()
