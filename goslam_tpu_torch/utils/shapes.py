"""Capacity bucketing.

Dynamic structures (edge sets, optimization windows) are padded to the
smallest capacity bucket, so every kernel sees one of a few shapes.
"""
from __future__ import annotations

from typing import Sequence

DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                   768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288,
                   12800, 16384, 24576, 32768)


def bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (raises if n exceeds the largest bucket)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"size {n} exceeds max bucket {buckets[-1]}")
