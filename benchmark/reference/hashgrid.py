"""A frozen copy of the port's plain ``mapping/hashgrid.py``, so that the
reference imports nothing of the program.

Multi-resolution hash-grid encoding (Instant-NGP), plain PyTorch.

The reference's configuration: 16 levels x 2 features, 2^19 entries per
level, base resolution 16, per-level growth 1.4472692.  Levels whose
dense grid fits the table index it densely; the others use the spatial
hash with primes (1, 2654435761, 805459861) on 32-bit unsigned
arithmetic, which is computed here in int64 with each product masked to
32 bits.  The eight corners of every level are gathered from one flat
table ``[L*T, F]`` in the natural ``[N, L, 8]`` layout with
``index_select``, which autograd differentiates twice (the eikonal term
differentiates the encoding's gradient again).  Output channels are
ordered ``l*F + f``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


def level_resolutions(n_levels: int = 16, base: int = 16,
                      growth: float = 1.4472692374403782) -> np.ndarray:
    return np.floor(base * growth ** np.arange(n_levels)).astype(np.int64)


class HashGrid(nn.Module):
    """x in [0, 1]^3 -> [..., n_levels * n_features]."""

    def __init__(self, n_levels: int = 16, n_features: int = 2,
                 log2_table: int = 19, base_res: int = 16,
                 growth: float = 1.4472692374403782):
        super().__init__()
        self.n_levels, self.n_features = n_levels, n_features
        self.table_size = T = 1 << log2_table
        res = level_resolutions(n_levels, base_res, growth)
        self.register_buffer("res", torch.from_numpy(res), persistent=False)
        self.register_buffer("dense", torch.from_numpy((res + 1) ** 3 <= T),
                             persistent=False)
        self.register_buffer("primes", torch.tensor(PRIMES), persistent=False)
        self.table = nn.Parameter(
            1e-4 * (2 * torch.rand(n_levels, T, n_features) - 1))

    def indices(self, x: torch.Tensor):
        """Table rows [N, L, 8] (within each level) and trilinear weights
        [N, L, 8] of the points x [N, 3]; corner c = 4i + 2j + k is the
        cell corner offset by (i, j, k)."""
        res = self.res
        T = self.table_size
        scaled = x[:, None, :] * (res - 1).to(x.dtype)[None, :, None]
        c0 = torch.floor(scaled).long()                        # [N, L, 3]
        frac = scaled - c0
        # per axis, the two corner coordinates [N, L, 3, 2], clamped
        c = torch.stack([c0, c0 + 1], dim=-1)
        c = torch.minimum(c.clamp(min=0), (res - 1)[None, :, None, None])
        stride = torch.stack([torch.ones_like(res), res, res * res], -1)
        d = c * stride[None, :, :, None]
        h = (c * self.primes[:, None]) & _MASK32

        def corners(a, op):
            """[N, L, 3, 2] per-axis terms -> [N, L, 8] over the corners."""
            ax, ay, az = a[:, :, 0], a[:, :, 1], a[:, :, 2]
            out = op(op(ax[..., :, None, None], ay[..., None, :, None]),
                     az[..., None, None, :])
            return out.reshape(out.shape[:2] + (8,))

        dense_idx = corners(d, torch.add) % T
        hashed = corners(h, torch.bitwise_xor) % T
        idx = torch.where(self.dense[None, :, None], dense_idx, hashed)

        f = frac[..., None]
        w = corners(torch.cat([1.0 - f, f], dim=-1), torch.mul)
        return idx, w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L, F, T = self.n_levels, self.n_features, self.table_size
        lead = x.shape[:-1]
        pts = x.reshape(-1, 3)
        idx, w = self.indices(pts)
        flat = idx + torch.arange(L, device=x.device)[None, :, None] * T
        feats = torch.index_select(self.table.reshape(L * T, F), 0,
                                   flat.reshape(-1))
        feats = feats.view(idx.shape + (F,))                   # [N,L,8,F]
        out = (feats * w[..., None]).sum(dim=2)                # [N, L, F]
        return out.reshape(lead + (L * F,))
