#!/usr/bin/env python3
"""ATE of the JAX package on chip_smoke.py's mono-128 and stereo-128 paths.

    JAX_PLATFORMS=cpu python scripts/mode_reference_jax.py [--modes mono,stereo]
        [--out DIR]

Runs the JAX package's SLAMSystem, tracking only, over each path's
configuration (``chip_smoke.mode_config``: accuracy-128's synthetic room,
40 frames at 128x192, ``checkpoints/droid_synthetic.ckpt``, in mode
``mono`` or ``stereo``, without depth) on the frames
``chip_smoke.mode_frames`` makes (in stereo the right view rendered by
``chip_smoke.stereo_right``), then ``terminate``, and prints one JSON
line per mode: keyframes, ATE RMSE and Sim3 scale, the stereo
self-edges (ii == jj) in the frontend's graph at the end, and seconds.
``chip_smoke.py`` gates the port's ATE on these paths at 1.5x the
readings (``JAX_MODE_128_CPU``).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(mode: str, out: str) -> dict:
    import jax
    import numpy as np

    from chip_smoke import CKPT, mode_config, mode_frames
    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.system import SLAMSystem, load_pretrained

    cfg = mode_config(mode)
    os.makedirs(out, exist_ok=True)
    frames = mode_frames(cfg, Synthetic(cfg))
    slam = SLAMSystem(cfg, params=load_pretrained(CKPT), output=out,
                      only_tracking=True)
    t0 = time.time()
    for i, (img, depth, intr, gt) in enumerate(frames):
        slam.track(float(i), img, depth, intr, gt)
    slam.flush()
    g = slam.frontend.graph
    self_edges = int((g.valid & (g.ii == g.jj)).sum())

    def stream():
        for i, (img, depth, intr, gt) in enumerate(frames):
            yield float(i), img, depth, intr, gt

    metrics = slam.terminate(stream())
    est = np.load(os.path.join(out, "est_poses.npy"))
    return {"device": str(jax.devices()[0].platform), "mode": mode,
            "keyframes": slam.video.counter,
            "ate_rmse": metrics["ate"]["rmse"],
            "ate_scale": metrics["ate"]["scale"],
            "finite": bool(np.isfinite(est).all()),
            "frontend_self_edges": self_edges,
            "seconds": time.time() - t0}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--modes", default="mono,stereo")
    parser.add_argument("--out", default=os.path.join(ROOT, "output",
                                                      "mode_reference_jax"))
    args = parser.parse_args()
    for mode in args.modes.split(","):
        print(json.dumps(run(mode, os.path.join(args.out, mode))),
              flush=True)


if __name__ == "__main__":
    main()
