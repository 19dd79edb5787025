"""VideoBuffer — the device-resident per-keyframe state store.

Preallocated tensors of capacity ``buffer`` on one device, updated in
place; the keyframe counter is a host int.  Layout (channels-last, bf16
for network features):
  * poses are w2c 7-vectors [tx ty tz qx qy qz qw], identity-initialized
  * disps live at 1/8 resolution, initialized to 1
  * sensor depth is subsampled at pixel centers [3::8, 3::8]
  * fmaps carry a rig dim (1 for mono/RGB-D)
  * images are kept at full resolution, float in [0, 1], for the mapper;
    the multiview filter publishes ``poses_filtered``,
    ``disps_filtered`` and ``mask_filtered`` up to ``filtered_id``, the
    scene ``bound`` and each keyframe's ``update_priority`` (host)
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lie, projective

_SHIFT_FIELDS = ("timestamp", "images", "poses", "poses_gt", "disps",
                 "disps_sens", "disps_up", "fmaps", "nets", "inps", "damping",
                 "poses_filtered", "disps_filtered", "mask_filtered")

# pairs per frame-distance batch (bounds the transient memory)
_DISTANCE_CHUNK = 4096


class VideoBuffer:
    def __init__(self, buffer: int, ht: int, wd: int, device,
                 device_scale: int = 8):
        self.buffer, self.ht, self.wd = buffer, ht, wd
        self.device = torch.device(device)
        self.device_scale = s = device_scale
        self.h8, self.w8 = h8, w8 = ht // s, wd // s
        self.rig = 1
        self.stereo = False

        self.counter = 0
        self.has_gt = False
        self.dirty = np.zeros((buffer,), bool)

        B, dev, f32 = buffer, self.device, torch.float32
        self.timestamp = torch.zeros((B,), dtype=f32, device=dev)
        self.poses = lie.identity((B,), device=dev)
        self.poses_gt = torch.eye(4, device=dev).repeat(B, 1, 1)
        self.disps = torch.ones((B, h8, w8), dtype=f32, device=dev)
        self.disps_sens = torch.zeros((B, h8, w8), dtype=f32, device=dev)
        self.disps_up = torch.zeros((B, ht, wd), dtype=f32, device=dev)
        self.intrinsics = torch.zeros((4,), dtype=f32, device=dev)  # 1/8 res
        bf16 = torch.bfloat16
        self.fmaps = torch.zeros((B, 1, h8, w8, 128), dtype=bf16, device=dev)
        self.nets = torch.zeros((B, h8, w8, 128), dtype=bf16, device=dev)
        self.inps = torch.zeros((B, h8, w8, 128), dtype=bf16, device=dev)
        # per-frame GRU damping state
        self.damping = torch.full((B, h8, w8), 1e-6, dtype=f32, device=dev)
        self.images = torch.zeros((B, ht, wd, 3), dtype=f32, device=dev)

        # multiview-filtered state for the mapper
        self.poses_filtered = lie.identity((B,), device=dev)
        self.disps_filtered = torch.zeros((B, ht, wd), dtype=f32, device=dev)
        self.mask_filtered = torch.zeros((B, ht, wd), dtype=f32, device=dev)
        self.filtered_id = -1
        self.update_priority = np.zeros((B,), np.float32)
        self.bound = np.zeros((3, 2), np.float32)
        self.pose_compensate = lie.identity(device=dev)

    def append(self, timestamp, pose, disp, depth, intrinsics, fmap, net,
               inp, gt_pose=None, image=None):
        """Write a new keyframe at the current counter.

        depth [ht, wd] or None; fmap [1, h8, w8, 128]; net/inp
        [h8, w8, 128]; pose / disp (scalar or [h8, w8]) may be None to
        keep the defaults; intrinsics [4] at 1/8 res or None; image
        [ht, wd, 3] in [0, 1] or None."""
        ix = self.counter
        if ix >= self.buffer:
            raise RuntimeError(f"keyframe buffer full ({self.buffer}); raise "
                               "tracking.buffer")
        self.timestamp[ix] = float(timestamp)
        if intrinsics is not None:
            self.intrinsics.copy_(intrinsics)
        if pose is not None:
            self.poses[ix] = pose
        if disp is not None:
            self.disps[ix] = disp
        if depth is not None:
            s = self.device_scale
            sub = depth[s // 2 - 1::s, s // 2 - 1::s]
            dsens = torch.where(sub > 0, 1.0 / torch.where(
                sub > 0, sub, torch.ones_like(sub)), torch.zeros_like(sub))
            self.disps_sens[ix] = dsens
            self.disps[ix] = torch.where(dsens > 0, dsens, self.disps[ix])
        if gt_pose is not None:
            self.has_gt = True
            self.poses_gt[ix] = gt_pose
        if image is not None:
            self.images[ix] = image
        self.fmaps[ix] = fmap
        self.nets[ix] = net
        self.inps[ix] = inp
        self.counter = ix + 1

    def remove_keyframe(self, ix: int):
        """Shift all state above ix down one slot (the last row stays)."""
        for name in _SHIFT_FIELDS:
            a = getattr(self, name)
            a[ix:-1] = a[ix + 1:].clone()
        self.update_priority[ix:-1] = self.update_priority[ix + 1:].copy()
        self.counter -= 1

    def set_pose(self, ix: int, pose):
        self.poses[ix] = pose

    def distance(self, ii, jj, beta=0.3, bidirectional=True) -> np.ndarray:
        """Frame-distance metric over index pairs (host arrays in and out)."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        out = []
        for s in range(0, len(ii), _DISTANCE_CHUNK):
            i = torch.as_tensor(ii[s:s + _DISTANCE_CHUNK], device=self.device)
            j = torch.as_tensor(jj[s:s + _DISTANCE_CHUNK], device=self.device)
            d = projective.frame_distance(self.poses, self.disps,
                                          self.intrinsics, i, j, beta)
            if bidirectional:
                d = 0.5 * (d + projective.frame_distance(
                    self.poses, self.disps, self.intrinsics, j, i, beta))
            out.append(d)
        if not out:
            return np.zeros((0,), np.float32)
        return torch.cat(out).cpu().numpy()

    def normalize(self):
        """Rescale disparities of the first `counter` frames to mean 1 and
        their translations to match (fixes the mono gauge)."""
        n = self.counter
        s = self.disps[:n].mean()
        self.disps[:n] /= s
        self.poses[:n, :3] *= s
        self.dirty[:n] = True

    def get_mapping_item(self, index: int, decay: float = 0.1):
        """One keyframe for the mapper: (image [ht, wd, 3], depth [ht, wd],
        c2w [4, 4], gt c2w, mask [ht, wd]); decays its update priority."""
        depth = 1.0 / (self.disps_filtered[index] + 1e-7)
        c2w = lie.matrix(lie.compose(self.pose_compensate,
                                     lie.inv(self.poses_filtered[index])))
        self.update_priority[index] *= decay
        return (self.images[index], depth, c2w, self.poses_gt[index],
                self.mask_filtered[index])
