"""Command-line entry point of the PyTorch port (tracking only).

    python -m goslam_tpu_torch.run configs/Demo/synthetic.yaml --only_tracking
        [--output DIR] [--max_frames N] [--image_size H W] [--device cpu]

Loads the YAML config chain, builds the dataset, tracks every frame,
then runs the final global BA, fills the trajectory and writes
``est_poses.npy`` and ``metrics_traj.txt`` to the output directory.
The port tracks RGB-D frames of the synthetic dataset, with or without
loop closing (``tracking.frontend.enable_loop``) and however many
keyframes the buffer holds; the other datasets, modes and mapping are
still to be ported (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="path to the scene config yaml")
    parser.add_argument("--only_tracking", action="store_true",
                        help="required: mapping is not ported yet")
    parser.add_argument("--output", default=None)
    parser.add_argument("--max_frames", type=int, default=-1)
    parser.add_argument("--image_size", type=int, nargs=2, default=None)
    parser.add_argument("--device", default=None,
                        help="default: the GPU (cuda)")
    args = parser.parse_args(argv)

    from .config import load_config
    from .data.synthetic import Synthetic
    from .system import SLAMSystem

    cfg = load_config(args.config)
    if args.only_tracking:
        cfg["only_tracking"] = True
    if args.output:
        cfg["data"]["output"] = args.output
    if args.image_size is not None:
        cfg["cam"]["H_out"], cfg["cam"]["W_out"] = args.image_size
    if cfg.get("dataset") != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.get('dataset')!r} is not ported yet; the port "
            f"reads the synthetic dataset")

    output = cfg["data"]["output"] or "output"
    os.makedirs(output, exist_ok=True)
    dataset = Synthetic(cfg)
    n_frames = len(dataset)
    if args.max_frames > 0:
        n_frames = min(n_frames, args.max_frames)
    print(f"dataset: {cfg['dataset']} frames: {n_frames} mode: "
          f"{cfg['mode']}")

    slam = SLAMSystem(cfg, output=output,
                      only_tracking=cfg.get("only_tracking", False),
                      device=args.device)
    t0 = time.time()
    for i in range(n_frames):
        idx, image, depth, intrinsics, gt_pose = dataset[i]
        slam.track(float(i), image, depth, intrinsics, gt_pose)
    elapsed = time.time() - t0
    print(f"tracking done: {n_frames} frames in {elapsed:.1f}s "
          f"({n_frames / elapsed:.2f} fps), {slam.video.counter} keyframes")

    def stream():
        for i in range(n_frames):
            yield (float(i),) + tuple(dataset[i][1:])

    metrics = slam.terminate(stream=stream())
    print(json.dumps(metrics, indent=2, default=str))
    return metrics


if __name__ == "__main__":
    main()
