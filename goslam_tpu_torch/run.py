"""Command-line entry point of the PyTorch port.

    python -m goslam_tpu_torch.run configs/Replica/room0.yaml
        [--mode mono|stereo|rgbd] [--only_tracking] [--input_folder DIR]
        [--output DIR] [--max_frames N] [--stride N] [--image_size H W]
        [--calibration_txt FILE] [--resume go.ckpt] [--device cpu]

Loads the YAML config chain, writes it as ``config.yaml`` next to the
outputs with a copy of this package's source (``code_backup/``), builds
the config's dataset (any of ``data.datasets.get_dataset``'s), tracks
every frame (depth only in ``rgbd``; mapping every
``mapping.mapping_every`` keyframes unless ``--only_tracking``), then
terminates: the final global BA, the checkpoint ``go.ckpt``, the filled
trajectory ``est_poses.npy`` and its ATE ``metrics_traj.txt`` or,
without ground truth, ``submission.txt``; with mapping, the final
mapping rounds, the meshes ``mesh/*.ply`` and, with
``meshing.eval_rec``, ``metrics_mesh.txt`` against the GT mesh
(``meshing.gt_mesh_path``, or the synthetic room's own).
``--calibration_txt`` holds ``fx fy cx cy``.  ``--make_video`` saves a
mesh after every mapping round and, once the run ends, renders the
meshes into ``mesh_video.mp4`` (``tools/meshvideo.py``, which needs
matplotlib and OpenCV); ``--viz`` runs the headless live viewer, which
writes ``pointcloud/*.ply``.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import time

import numpy as np


def setup_seed(seed: int = 43):
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def backup_source(output: str):
    """Copy this package's source to output/code_backup."""
    src = os.path.dirname(os.path.abspath(__file__))
    shutil.copytree(src, os.path.join(output, "code_backup",
                                      os.path.basename(src)),
                    ignore=shutil.ignore_patterns("build", "__pycache__"),
                    dirs_exist_ok=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="path to the scene config yaml")
    parser.add_argument("--mode", choices=["mono", "stereo", "rgbd"],
                        default=None)
    parser.add_argument("--only_tracking", action="store_true")
    parser.add_argument("--input_folder", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--max_frames", type=int, default=-1)
    parser.add_argument("--stride", type=int, default=None)
    parser.add_argument("--image_size", type=int, nargs=2, default=None)
    parser.add_argument("--calibration_txt", default=None)
    parser.add_argument("--make_video", action="store_true")
    parser.add_argument("--viz", action="store_true")
    parser.add_argument("--resume", default=None,
                        help="resume from a go.ckpt of an earlier run (of "
                             "this package or of the JAX package); frames "
                             "up to its last keyframe are skipped")
    parser.add_argument("--device", default=None,
                        help="default: the GPU (cuda)")
    args = parser.parse_args(argv)

    setup_seed(43)

    from .config import load_config, save_config
    from .data.datasets import get_dataset
    from .mapping import mesher as M
    from .system import SLAMSystem

    cfg = load_config(args.config)
    if args.mode:
        cfg["mode"] = args.mode
    if args.only_tracking:
        cfg["only_tracking"] = True
    if args.input_folder:
        cfg["data"]["input_folder"] = args.input_folder
    if args.output:
        cfg["data"]["output"] = args.output
    if args.stride is not None:
        cfg["stride"] = args.stride
    if args.image_size is not None:
        cfg["cam"]["H_out"], cfg["cam"]["W_out"] = args.image_size
    if args.max_frames > 0:
        cfg["data"]["max_frames"] = args.max_frames
    if args.calibration_txt:
        fx, fy, cx, cy = np.loadtxt(args.calibration_txt).tolist()
        cfg["cam"].update({"fx": fx, "fy": fy, "cx": cx, "cy": cy})
    if args.make_video:
        cfg["make_video"] = True
    if args.viz:
        cfg["viz"] = True

    output = cfg["data"]["output"] or "output"
    os.makedirs(output, exist_ok=True)
    backup_source(output)
    save_config(cfg, os.path.join(output, "config.yaml"))

    dataset = get_dataset(cfg)
    n_frames = len(dataset)
    if args.max_frames > 0:
        n_frames = min(n_frames, args.max_frames)
    print(f"dataset: {cfg['dataset']} frames: {n_frames} mode: "
          f"{cfg['mode']}")
    ts_all = np.asarray(dataset.timestamps, np.float64)[:n_frames] \
        if dataset.timestamps is not None \
        else np.arange(n_frames, dtype=np.float64)

    slam = SLAMSystem(cfg, output=output,
                      only_tracking=cfg.get("only_tracking", False),
                      device=args.device)
    start = 0
    if args.resume:
        state = slam.load_checkpoint(args.resume)
        last_ts = float(state["timestamps"][-1]) if state["counter"] else -1.0
        start = int((ts_all <= last_ts).sum())
        print(f"resumed {state['counter']} keyframes from {args.resume}; "
              f"continuing at frame {start}")

    def frames(first):
        for i in range(first, n_frames):
            _, image, depth, intrinsics, gt_pose = dataset[i]
            yield (float(ts_all[i]), image,
                   depth if cfg["mode"] == "rgbd" else None, intrinsics,
                   gt_pose)

    t0 = time.time()
    for item in frames(start):
        slam.track(*item)
    elapsed = time.time() - t0
    print(f"tracking done: {n_frames - start} frames in {elapsed:.1f}s "
          f"({(n_frames - start) / max(elapsed, 1e-9):.2f} fps), "
          f"{slam.video.counter} keyframes")

    gt_mesh_path = cfg["meshing"].get("gt_mesh_path", "")
    if (not gt_mesh_path and cfg["meshing"].get("eval_rec")
            and hasattr(dataset, "gt_mesh")):
        # the synthetic room's geometry is analytic: its GT mesh is
        # written next to the outputs
        gt_mesh_path = os.path.join(output, "gt_mesh.ply")
        M.save_ply(gt_mesh_path, *dataset.gt_mesh())

    metrics = slam.terminate(stream=frames(0), eval_mesh_path=gt_mesh_path)
    print(json.dumps(metrics, indent=2, default=str))
    if args.make_video:
        from .tools.meshvideo import make_video
        make_video(output)
    return metrics


if __name__ == "__main__":
    main()
