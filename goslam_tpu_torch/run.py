"""Command-line entry point of the PyTorch port.

    python -m goslam_tpu_torch.run configs/Demo/synthetic.yaml
        [--only_tracking] [--output DIR] [--max_frames N]
        [--image_size H W] [--resume go.ckpt] [--device cpu]

Loads the YAML config chain, builds the dataset, tracks every frame
(mapping every ``mapping.mapping_every`` keyframes unless
``--only_tracking``), then terminates: the final global BA, the
checkpoint ``go.ckpt``, the filled trajectory ``est_poses.npy`` and its
ATE ``metrics_traj.txt``; with mapping, the final mapping rounds, the
meshes ``mesh/*.ply`` and, with ``meshing.eval_rec``, ``metrics_mesh.txt``
against the dataset's GT mesh.  The port reads the synthetic dataset in
RGB-D mode; the other datasets and modes, ``--make_video`` and
``--viz`` raise (ROADMAP.md).  The JAX CLI's ``--input_folder``,
``--stride`` and ``--calibration_txt`` belong to the datasets still to
be ported and are not taken yet.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="path to the scene config yaml")
    parser.add_argument("--mode", choices=["mono", "stereo", "rgbd"],
                        default=None)
    parser.add_argument("--only_tracking", action="store_true")
    parser.add_argument("--output", default=None)
    parser.add_argument("--max_frames", type=int, default=-1)
    parser.add_argument("--image_size", type=int, nargs=2, default=None)
    parser.add_argument("--make_video", action="store_true")
    parser.add_argument("--viz", action="store_true")
    parser.add_argument("--resume", default=None,
                        help="resume from a go.ckpt of an earlier run (of "
                             "this package or of the JAX package); frames "
                             "up to its last keyframe are skipped")
    parser.add_argument("--device", default=None,
                        help="default: the GPU (cuda)")
    args = parser.parse_args(argv)

    from .config import load_config
    from .data.synthetic import Synthetic
    from .mapping import mesher as M
    from .system import SLAMSystem

    cfg = load_config(args.config)
    if args.mode:
        cfg["mode"] = args.mode
    if args.only_tracking:
        cfg["only_tracking"] = True
    if args.output:
        cfg["data"]["output"] = args.output
    if args.image_size is not None:
        cfg["cam"]["H_out"], cfg["cam"]["W_out"] = args.image_size
    if args.make_video:
        cfg["make_video"] = True
    if args.viz:
        cfg["viz"] = True
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
    start = 0
    if args.resume:
        state = slam.load_checkpoint(args.resume)
        last_ts = float(state["timestamps"][-1]) if state["counter"] else -1.0
        start = int((dataset.timestamps[:n_frames] <= last_ts).sum())
        print(f"resumed {state['counter']} keyframes from {args.resume}; "
              f"continuing at frame {start}")
    t0 = time.time()
    for i in range(start, n_frames):
        idx, image, depth, intrinsics, gt_pose = dataset[i]
        slam.track(float(i), image, depth, intrinsics, gt_pose)
    elapsed = time.time() - t0
    print(f"tracking done: {n_frames - start} frames in {elapsed:.1f}s "
          f"({(n_frames - start) / max(elapsed, 1e-9):.2f} fps), "
          f"{slam.video.counter} keyframes")

    def stream():
        for i in range(n_frames):
            yield (float(i),) + tuple(dataset[i][1:])

    gt_mesh_path = cfg["meshing"].get("gt_mesh_path", "")
    if not gt_mesh_path and cfg["meshing"].get("eval_rec"):
        # the synthetic room's geometry is analytic: its GT mesh is
        # written next to the outputs
        gt_mesh_path = os.path.join(output, "gt_mesh.ply")
        M.save_ply(gt_mesh_path, *dataset.gt_mesh())

    metrics = slam.terminate(stream=stream(), eval_mesh_path=gt_mesh_path)
    print(json.dumps(metrics, indent=2, default=str))
    return metrics


if __name__ == "__main__":
    main()
