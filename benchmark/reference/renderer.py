"""Ray sampling and rendering of the InstantNeuS: a frozen copy of the
port's plain ``mapping/renderer.py`` (``sample_z_vals``, ``render_rays``),
so that the reference imports nothing of the program."""
from __future__ import annotations

from typing import Dict, Optional

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
