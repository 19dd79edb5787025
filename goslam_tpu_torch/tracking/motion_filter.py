"""Keyframe admission by optical-flow magnitude.

Per incoming frame: encode matching and context features, estimate the
flow against the last keyframe with one update-operator iteration at zero
flow, and admit the frame as a keyframe when the mean predicted flow
exceeds a threshold (the first frame is always admitted).

A frame is a rig of views (one, or left and right in stereo): the
matching features are encoded for every view, the context and the flow
estimate use the left view alone.  The encoders and the update
iteration run in bf16 whatever ``tracking.compute_dtype`` says, as the
JAX package's filter does; the rolling last-keyframe state is kept in
fp32.
"""
from __future__ import annotations

import torch

from ..ops import corr, lie, projective
from .video import VideoBuffer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[..., 3] images in [0, 1] -> ImageNet-normalized."""
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    return (images - mean) / std


class MotionFilter:
    def __init__(self, net, video: VideoBuffer, thresh: float = 4.0):
        self.model = net
        self.video = video
        self.thresh = thresh
        self.count = 0
        self._seen_first = False
        self.dtype = torch.bfloat16

        h8, w8, dev = video.h8, video.w8, video.device
        f32 = torch.float32
        self.fmap = torch.zeros((video.rig, h8, w8, 128), dtype=f32,
                                device=dev)
        self.net = torch.zeros((1, h8, w8, 128), dtype=f32, device=dev)
        self.inp = torch.zeros((1, h8, w8, 128), dtype=f32, device=dev)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, ht, wd, 3] in [0, 1] -> fmaps [B, h8, w8, 128] bf16."""
        return self.model.fnet(normalize_images(images), self.dtype)

    @torch.no_grad()
    def track(self, timestamp, image, depth=None, intrinsics=None,
              gt_pose=None) -> bool:
        """Process one frame; append it to the video and return True when
        it is admitted as a keyframe.

        image [rig, ht, wd, 3] in [0, 1] and depth [ht, wd] (or None, as
        in mono and stereo) are tensors on the video's device; intrinsics
        [4] at full resolution."""
        first = not self._seen_first
        self._seen_first = True
        x = normalize_images(image)
        gmap = self.model.fnet(x, self.dtype)
        ctx_net, ctx_inp = self.model.encode_context(x[:1], self.dtype)

        # one update iteration at zero flow against the last keyframe
        levels = corr.build_pyramid(self.fmap[:1], gmap[:1])
        h8, w8 = self.video.h8, self.video.w8
        coords0 = projective.coords_grid(h8, w8, image.device)[None]
        c = corr.lookup(levels, coords0)
        _, delta, _ = self.model.update(self.net, self.inp, c,
                                        dtype=self.dtype)
        mag = torch.linalg.norm(delta.float(), dim=-1).mean()

        if not (first or float(mag) > self.thresh):
            self.count += 1
            return False
        self.count = 0
        self.fmap = gmap.float()
        self.net = ctx_net.float()
        self.inp = ctx_inp.float()

        intr = None
        if intrinsics is not None:
            intr = torch.as_tensor(intrinsics, dtype=torch.float32,
                                   device=image.device) \
                / float(self.video.device_scale)
        pose = lie.identity(device=image.device) if first else None
        disp = 1.0 if first else None
        gt = None if gt_pose is None else torch.as_tensor(
            gt_pose, dtype=torch.float32, device=image.device)
        self.video.append(timestamp, pose, disp, depth, intr, gmap,
                          ctx_net[0], ctx_inp[0], gt, image=image[0])
        return True
