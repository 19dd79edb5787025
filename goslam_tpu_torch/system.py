"""SLAMSystem: the tracking-only RGB-D pipeline on one device.

  per frame:     motion filter -> frontend (windowed BA; with
                 ``tracking.frontend.enable_loop`` every frontend update
                 ends in the backend's loop closing)
  per K kfs:     global dense BA (``tracking.global_ba_every``)
  terminate:     final dense BA x2, trajectory fill, ATE (Umeyama)

Frames are ingested synchronously.  They are quantized the way the JAX
package ships them to its device -- images to uint8, depth to fp16 -- so
both packages track the same inputs.  A failure inside global BA
propagates: it is never swallowed.

The system runs on the GPU unless the caller passes ``device="cpu"``; it
raises when no GPU is visible and none was asked for.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from .config import default_config
from .models.convert import load_checkpoint
from .models.droidnet import DroidNet, init_droidnet
from .ops import lie
from .tracking.backend import Backend
from .tracking.frontend import Frontend
from .tracking.motion_filter import MotionFilter
from .tracking.trajectory_filler import TrajectoryFiller
from .tracking.video import VideoBuffer
from .utils import evaluate


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, the GPU; raises when the GPU is asked for
    (explicitly or by default) and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU "
                "unless the caller asks for device='cpu'")
        # fp32 convolutions and matmuls mean fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


@dataclasses.dataclass
class TrackingResult:
    poses_w2c: np.ndarray          # [N, 7] keyframe poses
    timestamps: np.ndarray         # [N]
    n_keyframes: int


class SLAMSystem:
    def __init__(self, cfg: Optional[dict] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 output: Optional[str] = None, only_tracking: bool = False,
                 device=None):
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        cam = self.cfg["cam"]
        tr = self.cfg["tracking"]

        self.mode = self.cfg.get("mode", "mono")
        self.only_tracking = only_tracking or self.cfg.get(
            "only_tracking", False)
        if not self.only_tracking:
            raise NotImplementedError(
                "mapping and meshing are not ported yet (ROADMAP.md, queue "
                "A item 1); run with only_tracking")
        if self.mode != "rgbd":
            raise NotImplementedError(
                f"mode {self.mode!r} is not ported yet (ROADMAP.md, queue "
                f"A item 5); the port tracks RGB-D")
        self.output = output or self.cfg["data"].get("output", "") or "output"
        os.makedirs(self.output, exist_ok=True)

        pre = tr.get("pretrained", "")
        if state_dict is None and pre and os.path.exists(pre):
            state_dict = load_checkpoint(pre)
        if state_dict is None:
            net = init_droidnet()
        else:
            net = DroidNet()
            net.load_state_dict(state_dict)
        net.weight_calib.fill_(float(tr.get("weight_calib", 1.0)))
        self.net = net.to(self.device).eval()

        self.video = VideoBuffer(tr["buffer"], cam["H_out"], cam["W_out"],
                                 self.device)
        self.motion_filter = MotionFilter(self.net, self.video,
                                          thresh=tr["motion_filter"]["thresh"])
        self.backend = Backend(self.net, self.video, self.cfg)
        self.frontend = Frontend(self.net, self.video, self.cfg,
                                 loop_closing=self.backend)
        self.traj_filler = TrajectoryFiller(self.net, self.video,
                                            self.motion_filter)

        self.global_ba_every = tr.get("global_ba_every", 10)
        self._kf_since_ba = 0
        self.frame_count = 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def track(self, timestamp, image, depth=None, intrinsics=None,
              gt_pose=None):
        """Feed one frame: image [1, ht, wd, 3] float in [0, 1] (or
        uint8), depth [ht, wd] metres or None, intrinsics [4] (fx fy cx
        cy) at full resolution, gt_pose a 4x4 c2w or None.  Returns the
        list of admit decisions this call produced (one entry)."""
        self.frame_count += 1
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        img = torch.as_tensor(img, device=self.device).float() / 255.0
        dep = None
        if depth is not None:
            dep = torch.as_tensor(np.asarray(depth).astype(np.float16),
                                  device=self.device).float()
        return [self._drain_one(timestamp, img, dep, intrinsics, gt_pose)]

    def _drain_one(self, timestamp, img, dep, intrinsics, gt_pose) -> bool:
        """Motion filter, frontend and, every `global_ba_every` keyframes,
        global BA for one quantized frame.  Returns the admit decision."""
        is_kf = self.motion_filter.track(timestamp, img, dep, intrinsics,
                                         gt_pose)
        self.frontend()

        if is_kf and self.frontend.is_initialized:
            self._kf_since_ba += 1
            if (self.global_ba_every > 0
                    and self._kf_since_ba >= self.global_ba_every):
                self._kf_since_ba = 0
                self.backend.dense_ba(0, self.video.counter, steps=2)
        return is_kf

    def flush(self):
        """Ingest is synchronous: nothing is in flight.  Kept so callers of
        the JAX package's pipelined API work unchanged."""

    # ------------------------------------------------------------------
    def finalize_tracking(self, final_steps: int = 6) -> TrackingResult:
        """Two final global BA passes over all keyframes."""
        n = self.video.counter
        if n > 2 and self.frontend.is_initialized:
            self.backend.dense_ba(0, n, steps=final_steps)
            self.backend.dense_ba(0, n, steps=final_steps)
        return TrackingResult(
            poses_w2c=self.video.poses[:n].cpu().numpy(),
            timestamps=self.video.timestamp[:n].cpu().numpy(),
            n_keyframes=n)

    def terminate(self, stream=None) -> dict:
        """Final BA, trajectory fill over `stream` (the same items as
        track: timestamp, image, depth, intrinsics, gt_pose), and ATE.
        Writes est_poses.npy (c2w [N,4,4]) and, with ground truth,
        metrics_traj.txt into the output directory."""
        self.finalize_tracking()
        n = self.video.counter
        gt_record = []
        if stream is not None:
            def recording(s):
                for item in s:
                    gt_record.append(item[4])
                    yield item

            full_w2c = torch.as_tensor(self.traj_filler(recording(stream)))
            c2w = lie.matrix(lie.inv(full_w2c)).numpy()
        else:
            c2w = lie.matrix(lie.inv(self.video.poses[:n])).cpu().numpy()
            gt_record = list(self.video.poses_gt[:n].cpu().numpy()) \
                if self.video.has_gt else []
        np.save(os.path.join(self.output, "est_poses.npy"), c2w)

        metrics = {}
        if gt_record and all(p is not None for p in gt_record):
            res = evaluate.ate_rmse(c2w, np.stack(gt_record),
                                    correct_scale=True)
            metrics["ate"] = {k: v for k, v in res.items()
                              if k != "alignment"}
            with open(os.path.join(self.output, "metrics_traj.txt"),
                      "w") as f:
                json.dump(metrics["ate"], f, indent=2)
        return metrics
