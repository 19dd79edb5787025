"""Ray sampling and batched rendering.

The reference's sampling protocol:
  * near = 0.01 * gt depth (0.01 for rays without depth); far = the
    bound's exit distance, clamped to 1.2 x the batch's largest depth
  * N_surface samples in a +-10 % band around the depth; rays without
    depth sample uniformly from 0.001 to the largest depth
  * N_samples uniform near -> far with stratified jitter, merged and
    sorted with the surface samples

Random draws are arguments (``r`` of ``sample_z_vals``, ``u`` of
``sample_pdf``) so that the same draws can be fed to the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def sample_z_vals(r: Optional[torch.Tensor], rays_o, rays_d, gt_depth,
                  bound, n_samples: int, n_surface: int, depth_max=None):
    """Returns (z_vals [R, n_samples + n_surface], sample_dist [R, 1]).
    r [n_samples] uniform in [0, 1) jitters the uniform samples (one draw
    for every ray); None leaves them unjittered.  depth_max replaces the
    batch's largest depth (the far clamp, the surface range of rays
    without depth): a ray-sharded caller passes the whole batch's."""
    gt = gt_depth[:, None]
    near = gt * 0.01 + torch.where(gt > 0, 0.0, 0.01)
    if depth_max is None:
        depth_max = gt_depth.max()

    d = rays_d[:, None, :]
    t = (bound.T[None] - rays_o[:, None, :]) / torch.where(
        d.abs() < 1e-9, 1e-9, d)
    far_bb = t.amax(dim=1).amin(dim=1, keepdim=True) + 0.01
    far = torch.minimum(far_bb.clamp(min=0.0),
                        torch.clamp(depth_max * 1.2, min=1e-3))

    tv = torch.linspace(0.0, 1.0, n_samples, dtype=gt.dtype,
                        device=gt.device)[None]
    z_vals = near + (far - near) * tv
    sample_dist = (far - near) / n_samples

    if r is not None:
        mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mid, z_vals[:, -1:]], dim=1)
        lower = torch.cat([z_vals[:, :1], mid], dim=1)
        z_vals = lower + (upper - lower) * r[None]

    if n_surface > 0:
        ts = torch.linspace(0.0, 1.0, n_surface, dtype=gt.dtype,
                            device=gt.device)[None]
        valid = (gt > 0).to(gt.dtype)
        znear, zfar = 0.9 * gt, 1.1 * gt
        z_surf_valid = znear + (zfar - znear) * ts
        z_surf_invalid = 0.001 + (depth_max - 0.001) * ts
        z_surf = z_surf_valid * valid + z_surf_invalid * (1 - valid)
        z_vals = torch.sort(torch.cat([z_vals, z_surf], dim=1), dim=1)[0]
    return z_vals, sample_dist


def render_rays(model, r, rays_o, rays_d, gt_depth, bound, realtime_bound,
                n_samples: int, n_surface: int,
                depth_max=None) -> Dict[str, torch.Tensor]:
    """Sample and volume-render one ray batch (depth_max: see
    sample_z_vals)."""
    z_vals, sample_dist = sample_z_vals(r, rays_o, rays_d, gt_depth, bound,
                                        n_samples, n_surface, depth_max)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], sample_dist], dim=1)
    return model(rays_o, rays_d, z_vals, dists, bound, realtime_bound)


def build_ray_dirs(H: int, W: int, fx, fy, cx, cy,
                   device=None) -> torch.Tensor:
    """Per-pixel camera-frame ray directions [H, W, 3] (z = 1)."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                       dim=-1)


def rays_from_pixels(c2w, dirs_cam, pix_y, pix_x):
    """World rays (rays_o, rays_d [R, 3]) of the chosen pixels; c2w
    [4, 4], dirs_cam [H, W, 3], pix_y / pix_x [R]."""
    rays_d = dirs_cam[pix_y, pix_x] @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def sample_pdf(u: torch.Tensor, bins, weights) -> torch.Tensor:
    """Importance samples from the piecewise-constant pdf of `weights`
    over `bins`; u [..., n] uniform draws."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    # searchsorted's left side, as jnp.searchsorted
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous())
    idx = idx.clamp(1, cdf.shape[-1] - 1)
    c0 = torch.gather(cdf, -1, idx - 1)
    c1 = torch.gather(cdf, -1, idx)
    nb = bins.shape[-1]
    b0 = torch.gather(bins, -1, (idx - 1).clamp(0, nb - 1))
    b1 = torch.gather(bins, -1, idx.clamp(0, nb - 1))
    t = torch.where(c1 - c0 < 1e-8, 0.5,
                    (u - c0) / torch.clamp(c1 - c0, min=1e-8))
    return b0 + t * (b1 - b0)


@torch.no_grad()
def render_img(model, c2w, H: int, W: int, fx, fy, cx, cy, bound,
               realtime_bound, gt_depth=None, n_samples: int = 24,
               n_surface: int = 48, ray_chunk: int = 4096):
    """Render a whole image in ray chunks, unjittered.  Returns numpy
    [H, W, ...] images: color, depth, depth_variance, normal,
    weight_sum.  A chunk's largest depth sets its far clamp, so the last
    chunk is padded with depthless rays to the chunk size."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=bound.device)
    dirs = build_ray_dirs(H, W, fx, fy, cx, cy, bound.device).reshape(-1, 3)
    rays_d_all = dirs @ c2w[:3, :3].T
    rays_o_all = c2w[:3, 3].expand(rays_d_all.shape)
    n = H * W
    gt = torch.zeros(n, device=bound.device) if gt_depth is None else \
        torch.as_tensor(gt_depth, dtype=torch.float32,
                        device=bound.device).reshape(-1)
    outs = {}
    for i in range(0, n, ray_chunk):
        k = min(ray_chunk, n - i)
        ro, rd, g = rays_o_all[i:i + k], rays_d_all[i:i + k], gt[i:i + k]
        if k < ray_chunk:
            rep = torch.arange(ray_chunk - k, device=ro.device) % k
            ro = torch.cat([ro, ro[rep]])
            rd = torch.cat([rd, rd[rep]])
            g = torch.cat([g, g.new_zeros(len(rep))])
        ret = render_rays(model, None, ro, rd, g, bound, realtime_bound,
                          n_samples, n_surface)
        for name in ("color", "depth", "depth_variance", "normal",
                     "weight_sum"):
            outs.setdefault(name, []).append(ret[name][:k].cpu().numpy())
    return {k: np.concatenate(v).reshape((H, W) + v[0].shape[1:])
            for k, v in outs.items()}
