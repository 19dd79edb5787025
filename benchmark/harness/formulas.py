"""Frozen operation and byte counts: the same work counts the same
however a later version of the program implements it.

DroidNet's FLOPs are those of its convolutions at the published widths
(2 per multiply-add, bias left out, as torch's FLOP counter counts a
convolution); elementwise work is not counted.  A kernel's bytes count
each input byte it needs once and each output byte once.
"""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)

CORR_CHANNELS = 196
# fp32 operations per pixel of the edge-system kernel (K1): the
# reprojection, the Jacobians and the 27 pose-j Gram sums
K1_FLOP_PER_PX = 220
# fp32 operations per output channel of the alt-corr kernel's (K2)
# bilinear combine
K2_FLOP_PER_CH = 11


def _out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def conv_flops(b: int, cin: int, cout: int, k: int, hout: int,
               wout: int) -> int:
    return 2 * b * cin * cout * k * k * hout * wout


def encoder_flops(b: int, h: int, w: int, out_dim: int) -> int:
    """BasicEncoder (fnet 128, cnet 256) on b images of h x w."""
    f = 0
    h, w = _out(h, 7, 2), _out(w, 7, 2)
    f += conv_flops(b, 3, 32, 7, h, w)
    cin = 32
    for cout, stride in ((32, 1), (64, 2), (128, 2)):
        h2, w2 = _out(h, 3, stride), _out(w, 3, stride)
        f += conv_flops(b, cin, cout, 3, h2, w2)          # block 0 conv1
        f += conv_flops(b, cout, cout, 3, h2, w2)         # block 0 conv2
        if stride > 1:
            f += conv_flops(b, cin, cout, 1, h2, w2)      # downsample
        f += 2 * conv_flops(b, cout, cout, 3, h2, w2)     # block 1
        h, w, cin = h2, w2, cout
    return f + conv_flops(b, 128, out_dim, 1, h, w)


def update_flops(e: int, h: int, w: int) -> int:
    """UpdateModule on e edges of h x w (GraphAgg apart)."""
    c = lambda ci, co, k: conv_flops(e, ci, co, k, h, w)  # noqa: E731
    f = c(CORR_CHANNELS, 128, 1) + c(128, 128, 3)         # corr encoder
    f += c(4, 128, 7) + c(128, 64, 3)                     # flow encoder
    f += 3 * c(128 + 128 + 128 + 64, 128, 3)              # z, r, q
    f += c(128, 128, 1)                                   # global gate
    f += 3 * conv_flops(e, 128, 128, 1, 1, 1)             # *_glo
    f += 2 * (c(128, 128, 3) + c(128, 2, 3))              # delta, weight
    return f


def edge_features_flops(e: int, h: int, w: int) -> int:
    return conv_flops(e, 128, 128, 3, h, w)


def frame_head_flops(p: int, h: int, w: int, upmask: bool) -> int:
    f = conv_flops(p, 128, 128, 3, h, w) + conv_flops(p, 128, 1, 3, h, w)
    return f + (conv_flops(p, 128, 576, 1, h, w) if upmask else 0)


def edge_system_work(n_src, n_pose, e_all, e_valid, hw):
    """K1 over e_all edge slots, e_valid of them valid: (bytes, fp32
    operations).  Read once: the source frames' disparity rows, the
    valid edges' targets and weights, the touched poses, ii/jj (int64),
    valid, the intrinsics; written once: H [E,12,12], v [E,12], Eii and
    Eij [E,6,hw], Cii and bz [E,hw] for every slot."""
    nbytes = (n_src * hw * 4 + e_valid * hw * 16 + n_pose * 7 * 4
              + e_all * 17 + 16
              + e_all * (144 + 12) * 4 + e_all * hw * 14 * 4)
    return nbytes, e_valid * hw * K1_FLOP_PER_PX


def alt_corr_work(map_bytes, e, p1, levels, taps):
    """K2 over e edges of p1 pixels: (bytes, bf16 operations, fp32
    operations).  map_bytes: the pyramid levels of the maps the edges
    read (level 0 of every ii and jj map, levels 1.. of the jj maps),
    read once; coords fp32, ii/jj int32 read; the output [e, p1, L*49]
    fp32 written.  taps: the in-bounds taps, each a 128-channel dot
    product."""
    nbytes = map_bytes + e * p1 * 8 + e * 8 + e * p1 * levels * 49 * 4
    return nbytes, taps * 128 * 2, e * p1 * levels * 49 * K2_FLOP_PER_CH
