"""Correlation volumes, windowed lookup and on-the-fly alt-corr (PyTorch).

  * ``build_pyramid``: all-pairs volume of /4-scaled features, stored in
    bf16, then 2x2 average-pooled over the target dims (4 levels);
  * ``lookup``: 4 levels x (2r+1)^2 bilinear taps per pixel, read from
    the volume by a direct indexed gather of the (2r+2)^2 integer window;
  * ``alt_corr``: the same taps recomputed from feature pyramids without
    a volume (the backend's memory-lean correlation).  On a CUDA tensor it
    launches the hand-written kernel ``csrc/alt_corr.cu``; on a CPU tensor
    it runs ``alt_corr_plain``, the kernel's plain version.

Semantics: out-of-bounds taps contribute zero; channels are level-major,
then x-offset-major, then y-offset (channel = x_off * (2r+1) + y_off).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from . import kernels

NUM_LEVELS = 4
RADIUS = 3
# coordinates are clamped to this range before the integer window is
# formed: every tap of a pixel further out is out of bounds either way,
# and the clamp keeps the float->int conversion defined
_COORD_CLAMP = 1.0e4


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool over the last two dims (floor mode), computed in
    fp32 and returned in x's dtype."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w].float()
    x = x.reshape(x.shape[:-2] + (h // 2, 2, w // 2, 2))
    return x.mean(dim=(-3, -1))


def build_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                  num_levels: int = NUM_LEVELS) -> List[torch.Tensor]:
    """fmap1, fmap2: [E, h, w, C] -> levels [E, h*w, h/2^l, w/2^l] bf16."""
    E, h, w, C = fmap1.shape
    f1 = (fmap1.float() / 4.0).reshape(E, h * w, C)
    f2 = (fmap2.float() / 4.0).reshape(E, h * w, C)
    vol = torch.bmm(f1, f2.transpose(1, 2))
    levels = [vol.reshape(E, h * w, h, w).to(torch.bfloat16)]
    for _ in range(num_levels - 1):
        levels.append(_avg_pool2(levels[-1]).to(torch.bfloat16))
    return levels


def _floor_split(c: torch.Tensor):
    """Level coords -> (int64 floor, fractional part)."""
    c = c.clamp(-_COORD_CLAMP, _COORD_CLAMP)
    f = torch.floor(c)
    return f.long(), c - f


def _window_gather(vol: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Gather the (2r+2)^2 integer window at (y0-r.., x0-r..) per pixel.

    vol [E, P1, H2, W2]; x0/y0 [E, P1] int64.  Returns [E, P1, S(y), S(x)]
    fp32 with zeros out of bounds (the index is clamped to 0 there and
    the value masked: a gather must never be handed an index out of
    range)."""
    E, P1, H2, W2 = vol.shape
    S = 2 * radius + 2
    off = torch.arange(S, device=vol.device) - radius
    ay = y0[..., None, None] + off[:, None]
    ax = x0[..., None, None] + off[None, :]
    inb = (ay >= 0) & (ay < H2) & (ax >= 0) & (ax < W2)
    idx = torch.where(inb, ay * W2 + ax, torch.zeros_like(ay))
    taps = torch.gather(vol.reshape(E, P1, H2 * W2), 2,
                        idx.reshape(E, P1, S * S)).reshape(E, P1, S, S)
    return torch.where(inb, taps.float(), torch.zeros((), device=vol.device))


def _bilinear_window(taps: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """[E,P1,S,S] integer taps -> [E,P1,(2r+1)^2] bilinear samples,
    channel = x_offset * (2r+1) + y_offset."""
    rd = 2 * radius + 1
    dx = dx[..., None, None]
    dy = dy[..., None, None]
    out_yx = ((1 - dy) * (1 - dx) * taps[..., :rd, :rd]
              + (1 - dy) * dx * taps[..., :rd, 1:]
              + dy * (1 - dx) * taps[..., 1:, :rd]
              + dy * dx * taps[..., 1:, 1:])
    return out_yx.transpose(-1, -2).reshape(taps.shape[0], taps.shape[1],
                                            rd * rd)


def lookup(levels: Sequence[torch.Tensor], coords: torch.Tensor,
           radius: int = RADIUS) -> torch.Tensor:
    """Sample the volume pyramid at per-pixel coords.

    coords [E, h1, w1, 2] (x, y) in level-0 pixels.
    Returns [E, h1, w1, L*(2r+1)^2] fp32, level-major channels."""
    E, h1, w1, _ = coords.shape
    P1 = h1 * w1
    out = []
    for lvl, vol in enumerate(levels):
        x0, dx = _floor_split(coords[..., 0].reshape(E, P1) / 2 ** lvl)
        y0, dy = _floor_split(coords[..., 1].reshape(E, P1) / 2 ** lvl)
        taps = _window_gather(vol, x0, y0, radius)
        out.append(_bilinear_window(taps, dx, dy, radius))
    return torch.cat(out, dim=-1).reshape(E, h1, w1, -1)


# ---------------------------------------------------------------------------
# memory-lean on-the-fly correlation
# ---------------------------------------------------------------------------

def build_feature_pyramid(fmaps: torch.Tensor,
                          num_levels: int = NUM_LEVELS) -> List[torch.Tensor]:
    """fmaps [T, h, w, C] -> average-pooled levels [T, h/2^l, w/2^l, C]
    bf16, each /4-scaled (the pooling runs in fp32)."""
    f = fmaps.float() / 4.0
    levels = [f.to(torch.bfloat16)]
    cur = f
    for _ in range(num_levels - 1):
        cur = _avg_pool2(cur.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        levels.append(cur.to(torch.bfloat16).contiguous())
    return levels


def alt_corr_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                   ii: torch.Tensor, jj: torch.Tensor,
                   radius: int = RADIUS) -> torch.Tensor:
    """Plain version of the alt-corr kernel.

    levels: feature pyramid [T, h_l, w_l, C] bf16; coords [E, h1, w1, 2]
    (x, y) in level-0 pixels of frame jj; ii/jj [E] frame indices,
    clamped into [0, T) the way a JAX gather clamps.
    Returns [E, h1, w1, L*(2r+1)^2] fp32.

    The dot products of the bf16 features are formed in fp32 (each
    product of two bf16 values is exact in fp32): per level one fp32
    volume f1 . f2_l^T, from which the (2r+2)^2 window is gathered.
    """
    E, h1, w1, _ = coords.shape
    P1 = h1 * w1
    T = levels[0].shape[0]
    ii = ii.long().clamp(0, T - 1)
    jj = jj.long().clamp(0, T - 1)
    f1 = levels[0][ii].reshape(E, P1, -1).float()
    out = []
    for lvl, flvl in enumerate(levels):
        _, H2, W2, C = flvl.shape
        f2 = flvl[jj].reshape(E, H2 * W2, C).float()
        vol = torch.bmm(f1, f2.transpose(1, 2)).reshape(E, P1, H2, W2)
        x0, dx = _floor_split(coords[..., 0].reshape(E, P1) / 2 ** lvl)
        y0, dy = _floor_split(coords[..., 1].reshape(E, P1) / 2 ** lvl)
        taps = _window_gather(vol, x0, y0, radius)
        out.append(_bilinear_window(taps, dx, dy, radius))
    return torch.cat(out, dim=-1).reshape(E, h1, w1, -1)


def alt_corr(levels: Sequence[torch.Tensor], coords: torch.Tensor,
             ii: torch.Tensor, jj: torch.Tensor,
             radius: int = RADIUS) -> torch.Tensor:
    """On-the-fly windowed correlation for edges (ii -> jj); see
    alt_corr_plain for the arguments.  CUDA tensors launch the kernel
    (csrc/alt_corr.cu), CPU tensors take the plain version."""
    if coords.device.type == "cpu":
        return alt_corr_plain(levels, coords, ii, jj, radius)
    args = alt_corr_kernel_inputs(levels, coords, ii, jj, radius)
    E, h1, w1, _ = coords.shape
    out = torch.empty((E, h1, w1, len(args[0]) * (2 * radius + 1) ** 2),
                      dtype=torch.float32, device=coords.device)
    kernels.alt_corr(*args, out)
    return out


def alt_corr_kernel_inputs(levels, coords, ii, jj, radius: int = RADIUS):
    """Check the arguments of alt_corr and lay them out as the kernel
    reads them: (levels, coords [E,h,w,2] fp32, ii/jj [E] int32)."""
    E, h1, w1, _ = coords.shape
    lv = list(levels)
    if radius != RADIUS or not 1 <= len(lv) <= NUM_LEVELS:
        raise ValueError(f"alt_corr kernel takes radius {RADIUS} and 1-"
                         f"{NUM_LEVELS} levels, got {radius}, {len(lv)}")
    T = lv[0].shape[0]
    for l, f in enumerate(lv):
        if (f.dtype != torch.bfloat16 or f.dim() != 4 or f.shape[0] != T
                or f.shape[-1] != kernels.ALT_CORR_CHANNELS
                or not f.is_contiguous() or f.device != coords.device
                or f.data_ptr() % 16):
            raise ValueError(f"alt_corr level {l}: expected a contiguous, "
                             f"16-byte aligned "
                             f"[{T}, h, w, {kernels.ALT_CORR_CHANNELS}] bf16 "
                             f"tensor on {coords.device}, got "
                             f"{tuple(f.shape)} {f.dtype} on {f.device}")
    if lv[0].shape[1] * lv[0].shape[2] != h1 * w1:
        raise ValueError("alt_corr: coords must cover level 0's pixels")
    if coords.dtype != torch.float32 or ii.shape != (E,) or jj.shape != (E,):
        raise ValueError("alt_corr: coords must be fp32 [E, h, w, 2] and "
                         "ii/jj [E]")
    return (lv, coords.contiguous(), ii.to(torch.int32).contiguous(),
            jj.to(torch.int32).contiguous())
