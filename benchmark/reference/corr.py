"""Windowed correlation lookup, plain and in fp32.

Per edge, the all-pairs dot products of the source frame's /4-scaled
features with the target frame's features average-pooled 2x2 per level
(4 levels; pooling the features equals pooling the volume), then
(2r+1)^2 bilinear taps around each pixel's coordinates per level, zero
out of bounds; channels level-major, then x offset, then y offset.
The port stores the frontend's volumes in bf16 and computes the
backend's from bf16 features; here everything after the stored bf16
features is fp32.
"""
from __future__ import annotations

import torch

NUM_LEVELS = 4
RADIUS = 3
_COORD_CLAMP = 1.0e4


def _pool2(x):
    """[E, h, w, C] -> 2x2/2 average pool (floor mode)."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return x.reshape(x.shape[0], h // 2, 2, w // 2, 2,
                     x.shape[-1]).mean(dim=(2, 4))


def _floor_split(c):
    c = c.clamp(-_COORD_CLAMP, _COORD_CLAMP)
    f = torch.floor(c)
    return f.long(), c - f


def _window(vol, x0, y0, r):
    E, P1, H2, W2 = vol.shape
    S = 2 * r + 2
    off = torch.arange(S, device=vol.device) - r
    ay = y0[..., None, None] + off[:, None]
    ax = x0[..., None, None] + off[None, :]
    inb = (ay >= 0) & (ay < H2) & (ax >= 0) & (ax < W2)
    idx = torch.where(inb, ay * W2 + ax, torch.zeros_like(ay))
    taps = torch.gather(vol.reshape(E, P1, H2 * W2), 2,
                        idx.reshape(E, P1, S * S)).reshape(E, P1, S, S)
    return torch.where(inb, taps, torch.zeros((), device=vol.device))


def _bilinear(taps, dx, dy, r):
    rd = 2 * r + 1
    dx, dy = dx[..., None, None], dy[..., None, None]
    out = ((1 - dy) * (1 - dx) * taps[..., :rd, :rd]
           + (1 - dy) * dx * taps[..., :rd, 1:]
           + dy * (1 - dx) * taps[..., 1:, :rd]
           + dy * dx * taps[..., 1:, 1:])
    return out.transpose(-1, -2).reshape(taps.shape[0], taps.shape[1],
                                         rd * rd)


def lookup(f1, f2, coords, block: int = 8, r: int = RADIUS):
    """f1, f2 [E, h, w, C] (any float dtype); coords [E, h, w, 2] (x, y)
    in level-0 pixels of f2's frame.  Returns [E, h, w, 4*(2r+1)^2]."""
    E, h, w, C = f1.shape
    P1 = h * w
    outs = []
    for s in range(0, E, block):
        a = f1[s:s + block].float() / 4.0
        b = f2[s:s + block].float() / 4.0
        c = coords[s:s + block]
        n = a.shape[0]
        a = a.reshape(n, P1, C)
        lv = []
        for l in range(NUM_LEVELS):
            if l:
                b = _pool2(b)
            H2, W2 = b.shape[1], b.shape[2]
            vol = torch.bmm(a, b.reshape(n, H2 * W2, C).transpose(1, 2))
            x0, dx = _floor_split(c[..., 0].reshape(n, P1) / 2 ** l)
            y0, dy = _floor_split(c[..., 1].reshape(n, P1) / 2 ** l)
            lv.append(_bilinear(_window(vol.reshape(n, P1, H2, W2), x0, y0,
                                        r), dx, dy, r))
        outs.append(torch.cat(lv, dim=-1).reshape(n, h, w, -1))
    return torch.cat(outs)
