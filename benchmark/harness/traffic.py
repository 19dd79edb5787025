"""The one traffic generator: a traffic file's parameters -> frames.

A traffic file (``traffic/<name>.json``) describes a camera path in the
synthetic room and how it is fed:

  motion_frames       frames along the orbit
  yaw_deg_per_frame   orbit angle between frames (360 / motion_frames
                      closes the orbit)
  radius_m, bob_m     orbit radius and height swing
  stills              frames after the motion, each the last motion pose
                      moved by at most still_jitter_m and still_jitter_deg
  replay              true: when the sequence ends a fresh system tracks
                      it again; false: the stills are cycled, same system
  warmup_frames       frames set-up tracks: with replay by a throwaway
                      system, and the window starts the sequence again
                      with a fresh one; without, by the window's own
                      system, and the window goes on from there
  steps               the kinds of step the window drives and the check
                      compares (``harness/check.py``'s SAMPLE): a window
                      whose sample lacks one of them is not correct

The seed draws the colour field's phases, the start yaw and the stills'
jitter; every seed gets the same number of frames, the same motion per
frame and the same schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import scene

KEYS = ("motion_frames", "yaw_deg_per_frame", "radius_m", "bob_m", "stills",
        "still_jitter_m", "still_jitter_deg", "replay", "warmup_frames",
        "steps")


@dataclass
class Sequence:
    images: np.ndarray            # [N, rig, ht, wd, 3] float32 in [0, 1]
    depths: Optional[np.ndarray]  # [N, ht, wd] float32, or None
    intrinsics: np.ndarray        # [4] at the output size
    c2w: np.ndarray               # [N, 4, 4] ground truth
    motion_frames: int
    replay: bool
    warmup_frames: int
    steps: tuple

    def __len__(self):
        return len(self.images)

    def feed(self) -> Iterator[Tuple[bool, int]]:
        """Endless (new_system, frame index) pairs: new_system is True
        where a fresh system must track from this frame on."""
        n, m = len(self), self.motion_frames
        yield True, 0
        k = 1
        while True:
            if k < n:
                yield False, k
                k += 1
            elif self.replay or n == m:
                yield True, 0
                k = 1
            else:
                k = m

    def item(self, k: int):
        """The frame as SLAMSystem.track takes it, after its timestamp:
        (image [rig, ht, wd, 3], depth or None, intrinsics, gt c2w)."""
        d = None if self.depths is None else self.depths[k]
        return self.images[k], d, self.intrinsics, self.c2w[k]


def check(traffic: dict) -> dict:
    missing = [k for k in KEYS if k not in traffic]
    extra = [k for k in traffic if k not in KEYS and not k.startswith("_")]
    if missing or extra:
        raise ValueError(f"traffic file: missing {missing}, unknown {extra}")
    return traffic


def make(traffic: dict, cfg: dict, seed: int, device) -> Sequence:
    """Render the sequence of `traffic` for configuration `cfg` from
    `seed` on `device`, and bring it to the host."""
    check(traffic)
    gen = torch.Generator(device="cpu").manual_seed(int(seed) % (2 ** 63))
    phases = (torch.rand(6, generator=gen, dtype=torch.float64)
              * 2 * math.pi).tolist()
    start = float(torch.rand(1, generator=gen, dtype=torch.float64)) \
        * 2 * math.pi
    m = int(traffic["motion_frames"])
    c2w = scene.orbit_poses(m, start, math.radians(
        traffic["yaw_deg_per_frame"]), traffic["radius_m"], traffic["bob_m"])
    n_still = int(traffic["stills"])
    if n_still:
        jit = scene.small_motion(gen, n_still, traffic["still_jitter_m"],
                                 traffic["still_jitter_deg"])
        c2w = torch.cat([c2w, c2w[-1:] @ jit])
    cam = cfg["cam"]
    ht, wd = cam["H_out"], cam["W_out"]
    intr = scene.loader_intrinsics(cam)
    half = cfg["data"]["room_half_size"]
    c2w_d = c2w.to(device)
    img, depth = scene.render(c2w_d, intr, ht, wd, half, phases)
    views = [img]
    if cfg["mode"] == "stereo":
        views.append(scene.render(scene.right_view(c2w_d), intr, ht, wd,
                                  half, phases)[0])
    images = torch.stack(views, dim=1).cpu().numpy()
    depths = depth.cpu().numpy() if cfg["mode"] == "rgbd" else None
    return Sequence(images, depths, np.asarray(intr, np.float32),
                    c2w.numpy(), m, bool(traffic["replay"]),
                    int(traffic["warmup_frames"]), tuple(traffic["steps"]))
