"""Multiview consistency filter: clean depths, masks and a bound for mapping.

Every keyframe's full-resolution disparities are cross-checked against
six neighbouring keyframes (depth agreement below ``thresh``); the
pixels that enough neighbours confirm form the mask, their world points
the scene bound.  Per-keyframe update priorities grow with the pose
change since the last publish (BundleFusion's translation + Euler-angle
metric).  Everything but a few scalars stays on the device: the masked
minima and maxima and the mask dilation are exact there, so the bound
and the masks are those of a host computation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import lie, projective
from ..utils import trace
from ..utils.shapes import bucket
from .video import VideoBuffer


def pose_priority_dist(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """L1 translation + 2x L1 Euler-angle difference of two poses."""
    def to_euler(p):
        tx, ty, tz = p[..., 0], p[..., 1], p[..., 2]
        x, y, z, w = p[..., 3], p[..., 4], p[..., 5], p[..., 6]
        roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1, 1))
        yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return torch.stack([tx, ty, tz, roll, pitch, yaw], -1)

    d = (to_euler(q0) - to_euler(q1)).abs()
    return d[..., :3].sum(-1) + 2.0 * d[..., 3:].sum(-1)


def resize_bilinear(x: torch.Tensor, ht: int, wd: int) -> torch.Tensor:
    """``jax.image.resize(x, (T, ht, wd), "bilinear")`` of x [T, h, w]:
    half-pixel centres, triangle-kernel weights renormalized over the
    taps inside the image, one weight matrix per axis."""
    return torch.einsum("thw,hH,wW->tHW", x,
                        _resize_weights(x.shape[1], ht, x.device),
                        _resize_weights(x.shape[2], wd, x.device))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image's triangle kernel (upsampling:
    the kernel is not widened)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0)


def _masked_bound(pts: torch.Tensor, mask: torch.Tensor,
                  enlarge: float = 1.0) -> torch.Tensor:
    """[3, 2] min / max of the masked points [..., 3], each side moved out
    by (enlarge - 1) / 2 of the extent."""
    m = mask[..., None]
    lo = torch.where(m, pts, float("inf")).reshape(-1, 3).amin(0)
    hi = torch.where(m, pts, float("-inf")).reshape(-1, 3).amax(0)
    edge = (hi - lo) * (enlarge - 1.0) / 2.0
    return torch.stack([lo - edge, hi + edge], dim=-1)


class MultiviewFilter:
    def __init__(self, video: VideoBuffer, cfg: dict, warmup: int = 8):
        mv = cfg["tracking"]["multiview_filter"]
        self.video = video
        self.thresh = mv["thresh"]
        self.visible_num = mv["visible_num"]
        self.kernel_size = mv["kernel_size"]
        self.bound_enlarge = mv["bound_enlarge_scale"]
        self.warmup = warmup
        # upsampled disparities when tracking makes them; else a bilinear
        # resize of the 1/8-resolution ones
        self.use_upsampled = bool(cfg["tracking"].get("upsample", True))

    def filter(self, T: int):
        """Masks [T, ht, wd] (bool) and world points [T, ht, wd, 3] of
        the first T keyframe slots, and the disparities they came from."""
        video = self.video
        intr_full = video.intrinsics * video.device_scale
        if self.use_upsampled:
            disps_full = video.disps_up[:T]
        else:
            disps_full = resize_bilinear(video.disps[:T], video.ht, video.wd)
        poses = video.poses[:T]
        counts = projective.depth_consistency_count(
            poses, disps_full, intr_full, self.thresh)
        mean_disp = disps_full.mean(dim=(1, 2), keepdim=True)
        masks = (counts >= self.visible_num) & (disps_full > 0.01 * mean_disp)
        c2w = lie.compose(video.pose_compensate[None], lie.inv(poses))
        pts = projective.iproj_world(lie.inv(c2w), disps_full, intr_full)
        return masks, pts, disps_full

    @torch.no_grad()
    def __call__(self) -> bool:
        """One filter pass; True when it published new filtered state."""
        with trace.span("slam.multiview_filter"):
            return self._publish()

    def _publish(self) -> bool:
        video = self.video
        cur_t = video.counter
        if video.filtered_id >= cur_t or cur_t <= self.warmup:
            return False

        # the slots past the counter take part as neighbours, as in a
        # padded batch of bucket(cur_t) frames
        masks, pts, disps_full = self.filter(bucket(cur_t))
        masks, pts = masks[:cur_t], pts[:cur_t]
        if int(masks.sum()) < 100:
            return False
        bound = _masked_bound(pts, masks)

        masks_ext = self._extend_masks(masks)
        if int(masks_ext.sum()) < 100:
            return False
        inb = ((pts > bound[:, 0]) & (pts < bound[:, 1])).all(dim=-1)
        masks_ext &= inb
        bound = _masked_bound(pts, masks_ext, self.bound_enlarge)

        prio = pose_priority_dist(video.poses_filtered[:cur_t],
                                  video.poses[:cur_t])
        video.update_priority[:cur_t] += prio.cpu().numpy()
        video.mask_filtered[:cur_t] = masks_ext.float()
        video.disps_filtered[:cur_t] = disps_full[:cur_t]
        video.poses_filtered[:cur_t] = video.poses[:cur_t]
        video.filtered_id = cur_t
        video.bound = bound.cpu().numpy()
        return True

    def _extend_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """Dilate each mask with a k x k max filter (k made odd); "inf"
        keeps every pixel, k < 2 none more."""
        k = self.kernel_size
        if isinstance(k, str) and k == "inf":
            return torch.ones_like(masks)
        k = int(k)
        if k < 2:
            return masks.clone()
        k = (k // 2) * 2 + 1
        return F.max_pool2d(masks[:, None].float(), k, stride=1,
                            padding=k // 2)[:, 0] > 0
