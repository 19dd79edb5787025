"""A frozen copy of the port's plain ``mapping/instant_neus.py``, so that the
reference imports nothing of the program.

InstantNeuS: the hash-grid SDF scene model with NeuS volume rendering.

  * SDFNetwork: hash-grid encoding (+ the normalized xyz) -> one linear
    layer -> (sdf, 31 features); xyz columns Gaussian, grid columns zero
  * ColorNetwork: sin-Fourier embedding sin(x B) (B [3, 33], trained) +
    normals + features -> 2 x 64 ReLU MLP -> sigmoid RGB
  * the NeuS inverse standard deviation exp(10 v) of one trained scalar
  * sigmoid-CDF alpha compositing, with samples outside the real-time
    bound masked out (sdf 100, no weight)
  * truncation-band SDF and free-space losses; the eikonal term
    differentiates d sdf / d x again with respect to the parameters

The parameter names follow the JAX package's tree (models/convert.py
carries its parameters over).  The gradient of the SDF with respect to
the points is taken with ``torch.autograd.grad``: under autograd it
keeps its graph (create_graph), so a loss on it trains the parameters;
under ``torch.no_grad`` it is computed and freed.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from .hashgrid import HashGrid


def normalize_3d(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Points to [-1, 1] within bound [3, 2]."""
    p = (p - bound[:, 0]) / (bound[:, 1] - bound[:, 0]) * 2.0 - 1.0
    return torch.clamp(p, -1.0, 1.0)


def in_bound(pts: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    return ((pts > bound[:, 0]) & (pts < bound[:, 1])).all(-1)


def _dense(d_in: int, d_out: int) -> nn.Linear:
    """A linear layer initialized as flax's Dense: truncated-normal
    weights of variance 1 / d_in, zero bias."""
    lin = nn.Linear(d_in, d_out)
    std = math.sqrt(1.0 / d_in) / 0.87962566103423978
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(lin.bias)
    return lin


class SDFNetwork(nn.Module):
    def __init__(self, d_out: int = 32):
        super().__init__()
        self.encoding = HashGrid()
        d_in = 3 + self.encoding.n_levels * self.encoding.n_features
        self.sdf_layer = nn.Linear(d_in, d_out)
        with torch.no_grad():
            self.sdf_layer.weight.zero_()
            self.sdf_layer.weight[:, :3].normal_(
                0.0, math.sqrt(2.0) / math.sqrt(d_out))
            self.sdf_layer.bias.zero_()

    def forward(self, pts_n: torch.Tensor):
        """pts_n [..., 3] in [-1, 1] -> (sdf [..., 1], feat [..., d_out-1])."""
        enc = self.encoding((pts_n + 1.0) / 2.0)
        out = self.sdf_layer(torch.cat([pts_n, enc], dim=-1))
        return out[..., 0:1], out[..., 1:]


class ColorNetwork(nn.Module):
    def __init__(self, d_feat: int = 31, d_hidden: int = 64,
                 n_layers: int = 2):
        super().__init__()
        self.B = nn.Parameter(25.0 * torch.randn(3, 33))
        d = 33 + 3 + d_feat
        self.hidden = nn.ModuleList()
        for _ in range(n_layers):
            self.hidden.append(_dense(d, d_hidden))
            d = d_hidden
        self.out = _dense(d, 3)

    def forward(self, pts, normals, feat):
        h = torch.cat([torch.sin(pts @ self.B), normals, feat], dim=-1)
        for layer in self.hidden:
            h = torch.relu(layer(h))
        return torch.sigmoid(self.out(h))


class InstantNeuS(nn.Module):
    """Scene model; bound and realtime_bound [3, 2] are call inputs (the
    multiview filter refines the scene extent at run time)."""

    def __init__(self, d_out: int = 32, d_hidden: int = 64,
                 n_layers: int = 2, init_val: float = 0.2,
                 scale_factor: float = 10.0, cos_anneal_ratio: float = 1.0):
        super().__init__()
        self.sdf_network = SDFNetwork(d_out)
        self.color_network = ColorNetwork(d_out - 1, d_hidden, n_layers)
        self.variance = nn.Parameter(torch.tensor(float(init_val)))
        self.scale_factor = scale_factor
        self.cos_anneal_ratio = cos_anneal_ratio

    def inv_s(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.variance * self.scale_factor),
                           1e-6, 1e6)

    def sdf_with_grad(self, pts: torch.Tensor, bound: torch.Tensor):
        """sdf [N, 1], features [N, d_out-1] and d sdf / d pts [N, 3] at
        world points pts [N, 3].  With autograd on, the gradient keeps
        its graph; under no_grad all three come back detached."""
        training = torch.is_grad_enabled()
        with torch.enable_grad():
            if not pts.requires_grad:
                pts = pts.detach().requires_grad_(True)
            sdf, feat = self.sdf_network(normalize_3d(pts, bound))
            grad, = torch.autograd.grad(sdf.sum(), pts,
                                        create_graph=training)
        if not training:
            sdf, feat = sdf.detach(), feat.detach()
        return sdf, feat, grad

    def get_alpha(self, sdf, gradients, dirs, dists):
        """NeuS alpha from the sigmoid CDF."""
        inv_s = self.inv_s()
        true_cos = (dirs * gradients).sum(-1, keepdim=True)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5)
                     * (1.0 - self.cos_anneal_ratio)
                     + torch.relu(-true_cos) * self.cos_anneal_ratio)
        est_next = sdf + iter_cos * dists[..., None] / 2.0
        est_prev = sdf - iter_cos * dists[..., None] / 2.0
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                           0.0, 1.0)

    def forward(self, rays_o, rays_d, z_vals, dists, bound,
                realtime_bound) -> Dict[str, torch.Tensor]:
        """Volume-render rays_o / rays_d [R, 3] at z_vals / dists [R, S]."""
        R, S = z_vals.shape
        z_vals = z_vals + dists / 2.0
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        dirs = rays_d[:, None, :].expand(R, S, 3)

        pts_f = pts.reshape(-1, 3)
        dirs_f = dirs.reshape(-1, 3)
        dists_f = dists.reshape(-1)
        mask = in_bound(pts_f, realtime_bound)[:, None]

        sdf_raw, feat, grad = self.sdf_with_grad(pts_f, bound)
        sdf = torch.where(mask, sdf_raw, 100.0)
        feat = torch.where(mask, feat, 0.0)
        grad = torch.where(mask, grad, 0.0)

        alpha = self.get_alpha(sdf, grad, dirs_f, dists_f)
        rgb = torch.where(mask, self.color_network(pts_f, grad, feat), 0.0)

        maskRS = mask.view(R, S).to(alpha.dtype)
        alpha = alpha.view(R, S) * maskRS
        rgb = rgb.view(R, S, 3)
        sdf = sdf.view(R, S)
        grad = grad.view(R, S, 3)

        trans = torch.cumprod(torch.cat(
            [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=1),
            dim=1)[:, :-1]
        weights = alpha * trans
        depth = (z_vals * weights).sum(1, keepdim=True)
        # grad-safe norm: the gradient of |0| is undefined and would send
        # NaN through the mask product into the parameters
        grad_norm = torch.sqrt((grad ** 2).sum(-1) + 1e-12)
        grad_err = ((grad_norm - 1.0) ** 2) * maskRS
        return {
            "color": (rgb * weights[..., None]).sum(1),              # [R, 3]
            "depth": depth,                                           # [R, 1]
            "depth_variance": (((z_vals - depth) ** 2) * weights).sum(
                1, keepdim=True),                                     # [R, 1]
            "normal": (grad * (weights * maskRS)[..., None]).sum(1),  # [R, 3]
            "weight_sum": weights.sum(1, keepdim=True),               # [R, 1]
            "sdf": sdf,                                               # [R, S]
            "z_vals": z_vals,                                         # [R, S]
            "gradient_error": grad_err.mean()[None],
        }

def compute_sdf_losses(sdf, z_vals, gt_depth, truncation: float,
                       sparse_factor: float) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Truncation-band SDF loss and free-space loss.

    sdf / z_vals [R, S]; gt_depth [R] (0 = no depth).  Returns
    (sdf_loss, front_loss), each normalized by the rays with depth."""
    gt = gt_depth[:, None]
    ray_ok = (gt_depth > 0).to(sdf.dtype)

    bound_dist = gt - z_vals
    front_mask = (z_vals < (gt - truncation)).to(sdf.dtype) * ray_ok[:, None]
    sdf_mask = (bound_dist.abs() <= truncation).to(sdf.dtype) \
        * ray_ok[:, None]

    n_valid = front_mask.sum(1) + sdf_mask.sum(1) + 1e-8
    n_rays = torch.clamp(ray_ok.sum(), min=1.0)

    front_loss = torch.maximum(
        torch.exp(torch.clamp(-sparse_factor * sdf, max=10.0)) - 1.0,
        sdf - bound_dist)
    front_loss = torch.clamp(front_loss, min=0.0) * front_mask
    front_sum = (front_loss.sum(1) / n_valid).sum()
    sdf_sum = (((sdf - bound_dist).abs() * sdf_mask).sum(1) / n_valid).sum()
    return sdf_sum / n_rays, front_sum / n_rays
