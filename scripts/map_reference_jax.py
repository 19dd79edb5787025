#!/usr/bin/env python3
"""Mesh metrics of the JAX package on chip_smoke.py's map-128 path.

    JAX_PLATFORMS=cpu python scripts/map_reference_jax.py [--out DIR]

Runs the JAX package's SLAMSystem over map-128's configuration
(``chip_smoke.map_config``: the synthetic room, RGB-D, 40 frames at
128x192, ``checkpoints/droid_synthetic.ckpt``, a mapper round every 5
keyframes, meshing at resolution 96 evaluated against
``Synthetic.gt_mesh()``) and prints one JSON line: the ATE, the mapper
rounds and train steps, the mesh metrics and the vertex and triangle
counts of the raw and culled meshes, and the learnt-map ratio of
``chip_smoke.py``'s ``mesh checks`` line: the trained map's median |SDF|
at the keyframes' observed points (the multiview filter's depth,
unprojected) over that of the same mapper's initial, untrained
parameters.  The mapper's seed is the JAX
package's default (0) unless ``--seed`` names another (its random
draws: the initial parameters, the ray keys, the jitter, the frame
schedule).  ``chip_smoke.py`` gates the port's mesh metrics on the
range of these numbers over seeds 0-6, and sets ``MAP_LEARNT_RATIO``
from the range of the ratio.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(ROOT, "output",
                                                      "map_reference_jax"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import CKPT, map_config
    from goslam_tpu.data.synthetic import Synthetic
    from goslam_tpu.mapping import mesher as M
    from goslam_tpu.mapping.instant_neus import InstantNeuS
    from goslam_tpu.mapping.mapper import Mapper
    from goslam_tpu.ops import projective
    from goslam_tpu.system import SLAMSystem, load_pretrained

    cfg = map_config()
    os.makedirs(args.out, exist_ok=True)
    ds = Synthetic(cfg)
    gv, gt_tris = ds.gt_mesh()
    gt_path = os.path.join(args.out, "gt_mesh.ply")
    M.save_ply(gt_path, gv, gt_tris)

    slam = SLAMSystem(cfg, params=load_pretrained(CKPT), output=args.out)
    if args.seed:
        slam.mapper = Mapper(slam.video, cfg, seed=args.seed)
    untrained = slam.mapper.params
    # count the mapper rounds (an instance attribute would not shadow
    # __call__, so the class's is wrapped)
    rounds = []
    call = type(slam.mapper).__call__

    def counted(self, the_end=False):
        rounds.append(the_end)
        return call(self, the_end)

    type(slam.mapper).__call__ = counted
    t0 = time.time()
    for i in range(len(ds)):
        _, img, depth, intr, gt = ds[i]
        slam.track(float(i), img, depth, intr, gt)
    slam.flush()

    def stream():
        for i in range(len(ds)):
            yield (float(i),) + tuple(ds[i][1:])

    metrics = slam.terminate(stream(), eval_mesh_path=gt_path)
    raw_v, raw_t = M.load_ply(os.path.join(args.out, "mesh",
                                           "final_raw.ply"))
    cull_v, cull_t = M.load_ply(os.path.join(args.out, "mesh",
                                             "cull_mesh.ply"))

    # the learnt-map ratio, as chip_smoke.mesh_checks reads it
    v = slam.video
    n = v.filtered_id
    observed = np.asarray(projective.iproj_world(
        v.poses_filtered[:n], jnp.maximum(v.disps_filtered[:n], 1e-6),
        v.intrinsics * v.device_scale))[np.asarray(v.mask_filtered[:n]) > 0]
    bnd = jnp.asarray(v.bound, jnp.float32)

    def sdf_at_observed(params):
        sdf = slam.mapper.model.apply({"params": params}, jnp.asarray(
            observed), bnd, bnd, method=InstantNeuS.sdf_grid)
        return float(np.median(np.abs(np.asarray(sdf))))

    fit = {"points": len(observed),
           "trained": sdf_at_observed(slam.mapper.params),
           "untrained": sdf_at_observed(untrained)}
    fit["ratio"] = fit["trained"] / fit["untrained"]
    print(json.dumps({
        "device": str(jax.devices()[0].platform), "seed": args.seed,
        "keyframes": slam.video.counter,
        "ate_rmse": metrics["ate"]["rmse"],
        "mapper_rounds": len(rounds),
        "final_rounds": sum(rounds),
        "train_steps": slam.mapper.global_step,
        "mesh": metrics.get("mesh"),
        "raw_mesh": [len(raw_v), len(raw_t)],
        "culled_mesh": [len(cull_v), len(cull_t)],
        "sdf_at_observed": fit,
        "seconds": time.time() - t0,
    }))


if __name__ == "__main__":
    main()
