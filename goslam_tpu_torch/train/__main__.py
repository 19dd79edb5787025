"""Train the DroidNet tracking checkpoint on the synthetic domain.

    python -m goslam_tpu_torch.train [--steps N] [--ht H] [--wd W]
        [--scenes N] [--multires HxW,...] [--lr LR] [--out PATH]
        [--log PATH] [--resume PATH] [--device cpu]

The flags and defaults of the JAX package's scripts/train_synthetic.py
(10,000 steps at 128x192 with 240x320 mixed in, written to
checkpoints/droid_synthetic.ckpt), and ``--device``: the GPU unless
``--device cpu`` is given; without a GPU and without it, the trainer
raises.  ``--resume`` starts from a trainer checkpoint (the JAX
package's or this one's).  The checkpoint loads in the port
(``tracking.pretrained``, ``models.convert.load_checkpoint``) and in the
JAX package alike.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--ht", type=int, default=128)
    ap.add_argument("--wd", type=int, default=192)
    ap.add_argument("--scenes", type=int, default=2048)
    ap.add_argument("--multires", default="240x320",
                    help="comma-separated extra HxW resolutions mixed "
                         "into the scene pool ('' to disable)")
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--out", default="checkpoints/droid_synthetic.ckpt")
    ap.add_argument("--log", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (cuda)")
    args = ap.parse_args(argv)

    from ..models.droidnet import DroidNet
    from ..system import resolve_device
    from .trainer import TrainConfig, fit, load_checkpoint

    device = resolve_device(args.device)
    multires = tuple(tuple(int(v) for v in r.split("x"))
                     for r in args.multires.split(",") if r)
    cfg = TrainConfig(steps=args.steps, n_scenes=args.scenes, lr=args.lr,
                      ht=args.ht, wd=args.wd, multires=multires)
    model = None
    if args.resume and os.path.exists(args.resume):
        model = DroidNet()
        model.load_state_dict(load_checkpoint(args.resume)[0])
        print(f"resumed from {args.resume}")
    fit(cfg, args.out, model=model, log_file=args.log or None,
        device=device)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
