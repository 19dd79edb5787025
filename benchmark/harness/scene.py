"""The synthetic room, rendered on the device from a seed.

A torch rewrite of the port's ``data/synthetic.py``: a camera inside the
axis-aligned box room [-half, half]^3 whose walls carry a smooth
periodic colour field; colour and projective depth come from the exit
point of each pixel's ray.  Three things come from the seed: the colour
field's six phases, the orbit's start yaw and, in a traffic with stills,
their jitter.  With zero phases and the port's poses and intrinsics it
renders the port's frames (``benchmark/tests``).

The stereo rig is the port's: the right camera 0.1 m along the left
camera's own x axis (c2w @ T(+0.1 x)), the baseline the tracker assumes.
"""
from __future__ import annotations

import math

import torch

STEREO_BASELINE_M = 0.1
# the colour field's frequencies and offsets, as the port's _texture
_FREQ = ((3.1, 2.3), (2.7, 1.9), (2.1, 2.9))
_OFFS = (1.7, 0.3, 2.9)


def loader_intrinsics(cam: dict):
    """fx fy cx cy at the output size, as the port's dataset loaders give
    them: the image resized to (H_out + 2 H_edge, W_out + 2 W_edge), the
    intrinsics scaled with it, then shifted by the edge crop."""
    h = cam["H_out"] + 2 * cam["H_edge"]
    w = cam["W_out"] + 2 * cam["W_edge"]
    sx, sy = w / cam["W"], h / cam["H"]
    return (cam["fx"] * sx, cam["fy"] * sy, cam["cx"] * sx - cam["W_edge"],
            cam["cy"] * sy - cam["H_edge"])


def texture(p: torch.Tensor, phases) -> torch.Tensor:
    """[..., 3] points -> [..., 3] colours in [0, 1]."""
    x, y, z = p.unbind(-1)
    (a0, a1), (b0, b1), (c0, c1) = _FREQ
    r = 0.5 + 0.5 * torch.sin(a0 * x + _OFFS[0] + phases[0]) \
        * torch.cos(a1 * y + phases[1])
    g = 0.5 + 0.5 * torch.sin(b0 * y + _OFFS[1] + phases[2]) \
        * torch.cos(b1 * z + phases[3])
    b = 0.5 + 0.5 * torch.sin(c0 * z + _OFFS[2] + phases[4]) \
        * torch.cos(c1 * x + phases[5])
    return torch.stack([r, g, b], dim=-1)


def render(c2w: torch.Tensor, intr, ht: int, wd: int, half: float,
           phases, block: int = 16):
    """c2w [N, 4, 4] fp32 -> (images [N, ht, wd, 3], depth [N, ht, wd]),
    on c2w's device, in blocks of `block` frames."""
    dev = c2w.device
    fx, fy, cx, cy = (float(v) for v in intr)
    j, i = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=dev),
                          torch.arange(wd, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                       dim=-1)
    images, depths = [], []
    for s in range(0, c2w.shape[0], block):
        T = c2w[s:s + block]
        d = torch.einsum("hwc,nrc->nhwr", dirs, T[:, :3, :3])
        o = T[:, :3, 3][:, None, None, :]
        t1 = (half - o) / d
        t2 = (-half - o) / d
        t = torch.where(d > 0, t1, t2)
        t = torch.where(d.abs() < 1e-9, torch.full_like(t, math.inf), t)
        t_exit = t.min(dim=-1).values
        images.append(texture(o + d * t_exit[..., None], phases))
        depths.append(t_exit * dirs[..., 2])
    return torch.cat(images), torch.cat(depths)


def orbit_poses(n: int, start_yaw: float, yaw_step: float, radius: float,
                bob: float, device=None) -> torch.Tensor:
    """The port's orbit (looking outward, yaw a, centre (0, 0, -0.5),
    height bob * sin(3a)) at angles start_yaw + k * yaw_step, [n, 4, 4]."""
    a = start_yaw + yaw_step * torch.arange(n, dtype=torch.float64,
                                            device=device)
    c, s = torch.cos(a), torch.sin(a)
    T = torch.zeros((n, 4, 4), dtype=torch.float64, device=device)
    T[:, 0, 0], T[:, 0, 2] = c, s
    T[:, 1, 1] = 1.0
    T[:, 2, 0], T[:, 2, 2] = -s, c
    T[:, 0, 3] = radius * s
    T[:, 1, 3] = bob * torch.sin(3 * a)
    T[:, 2, 3] = radius * c - 0.5
    T[:, 3, 3] = 1.0
    return T.float()


def small_motion(gen: torch.Generator, n: int, max_t: float,
                 max_deg: float, device=None) -> torch.Tensor:
    """n rigid motions [n, 4, 4]: a translation of length at most max_t
    and a rotation of at most max_deg about a random axis."""
    def unit(v):
        return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    u = torch.rand((n, 3), generator=gen, dtype=torch.float64, device=device)
    t = unit(torch.randn((n, 3), generator=gen, dtype=torch.float64,
                         device=device)) * (max_t * u[:, :1])
    axis = unit(torch.randn((n, 3), generator=gen, dtype=torch.float64,
                            device=device))
    ang = math.radians(max_deg) * u[:, 1:2]
    K = torch.zeros((n, 3, 3), dtype=torch.float64, device=device)
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    s, c = torch.sin(ang)[..., None], torch.cos(ang)[..., None]
    R = torch.eye(3, dtype=torch.float64, device=device) + s * K \
        + (1 - c) * (K @ K)
    M = torch.eye(4, dtype=torch.float64, device=device).repeat(n, 1, 1)
    M[:, :3, :3] = R
    M[:, :3, 3] = t
    return M.float()


def right_view(c2w: torch.Tensor) -> torch.Tensor:
    """The right camera of the rig for left cameras c2w [N, 4, 4]."""
    shift = torch.eye(4, device=c2w.device)
    shift[0, 3] = STEREO_BASELINE_M
    return c2w @ shift
