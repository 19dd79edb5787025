#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (goslam_tpu_torch) on one GPU.

    python3 chip_smoke.py              # everything, as a check on the card
    python3 chip_smoke.py --profile    # also timed and traced runs of two paths
    python3 chip_smoke.py --paths loop-160    # only some of the paths

Phases, each of which exits non-zero on failure (nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     goslam_tpu_torch/csrc with nvcc (one process per source, in parallel);
  2. check each kernel against its plain PyTorch version at small shapes:
     edge_system at the main path's form and at adversarial inputs
     (stereo edges, every edge invalid, E=1, pixels behind MIN_DEPTH, a
     ragged 7x11 frame, E=1024 at 30x40), two launches bit for bit, and
     the whole wrapper once under torch.cuda.set_sync_debug_mode("error");
     both fp32 versions are also held against the plain version in fp64,
     and phase 4 ends with each output's worst error (line "edge_system
     accuracy");
     alt_corr at pixel counts that are no multiple of its 64-pixel tile
     and at adversarial coordinates (NaN, +-1e6, tiles whose windows all
     miss the image, windows at the image border, windows over the whole
     frame), schur_matvec with frames of degree 0, a hub frame that 40
     edges point into, a hub frame that 60 edges leave, and hw = 100;
     fail on register spills in any kernel; and hold dba.ba with the PCG
     solver (whose matvec is the schur_matvec kernel) against the
     Cholesky solver on a band graph of 192 poses;
  3. the paths, each RGB-D tracking only on the synthetic scene with
     checkpoints/droid_synthetic.ckpt, through SLAMSystem.track /
     terminate, with the kernels' launch counts reset just before the run
     and read just after, and the shapes of every launch recorded:
       accuracy-128  40 frames at 128x192.  Gates: every pose finite,
                     ATE < 0.18 m, edge_system and alt_corr launched;
       accuracy-240  the same at 240x320 (finite, ATE < 0.25 m);
       loop-160      160 frames, two laps, at 128x192 with loop closing:
                     past 128 keyframes global BA and loop closing solve
                     with PCG.  Gates: every pose finite, at least 129
                     keyframes, all three kernels launched, a loop
                     candidate accepted, ATE < LOOP_ATE_GATE;
       loop-160-off  loop-160 without loop closing (reported beside it);
       loop-160-240  loop-160 at 240x320 (finite, all kernels launched);
     After accuracy-128, the host synchronizations of one more frontend
     step and of its dba.ba call are counted, with their sites
     (torch.cuda.set_sync_debug_mode("warn")): a measurement, not a gate;
  4. each kernel against its plain version at every shape a path gave it,
     with the kernel's device time (CUDA graph replay; for schur_matvec the
     whole matvec, scatter to jj included, one launch; for edge_system the
     whole wrapper, captured in the graph, which fails if it
     synchronizes), the uncaptured wrapper's and the plain version's time,
     and the bound (the least time the card could take for the same work)
     from this run's inputs.

The second line from the end is a JSON object listing the kernels, the
line before it the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device; exits non-zero
without printing a result when there is none.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "checkpoints", "droid_synthetic.ckpt")
# H100 SXM data-sheet peaks (at the full 700 W power limit): HBM3 bytes/s,
# fp32 FLOP/s outside the tensor cores, dense bf16 FLOP/s of the tensor
# cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
# ATE of the JAX package on the same 128x192 run, on a TPU v5e
JAX_ATE_128 = 0.1277
# gate of loop-160: about 1.5x the ATE the port measured on an H100
# (0.37-0.39 m over four runs; 0.48 m without loop closing)
LOOP_ATE_GATE = 0.58
# converged PCG against Cholesky after two Gauss-Newton steps on 192
# poses: poses (translations of ~1, unit quaternions) and disparities
# (~0.6); and how far PCG with global BA's budget of 32 iterations may lag
# Cholesky's pose error at 8x12, where tests/test_dba.py holds it
CG_CHOL_POSE_TOL = 5e-3
CG_CHOL_DISP_TOL = 1e-2
CG32_LAG = 1.5

# fp32 operations per pixel of the edge-system kernel, counted from
# csrc/edge_system.cu (a multiply-add counts two): the projection (22),
# the inverse depth, weights and residuals (14), the pose-j rows and the
# disparity Jacobian (24), Cii and bz (12), Eij (16) and Eii = M Eij
# (42), the 21 + 6 sums of the pose-j Gram over the u and v rows (92)
K1_FLOP_PER_PX = 220
# per output channel of alt-corr: the 4-tap bilinear combine (fp32)
K2_FLOP_PER_CH = 11


_T0 = time.perf_counter()


def say(text: str):
    """Print a progress line with the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:5.0f} s] {text}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() in ms over `iters` back-to-back calls, between
    CUDA events: the device's time, or the host's where the host cannot
    keep the device busy."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(launch, iters: int = 50) -> float:
    """Device time of one kernel launch in ms: `iters` launches captured
    in one CUDA graph and replayed, so the host's launch cost is out of
    the measurement."""
    launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            launch()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, op_seconds: float):
    """The least time for the work in ms, and what sets it: the bytes over
    the memory rate, or the operations over their peak rates."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = op_seconds * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def edge_problem(gen, E: int, ht8: int, wd8: int, P: int = 24,
                 kind: str = "path"):
    """Inputs of the edge-system kernel.  path: the main path's form,
    poses near identity, disparities 0.3-0.8, targets near the
    reprojection, one in eight edge slots invalid (padding); stereo: a
    quarter of the edges with ii == jj; invalid: every edge invalid;
    behind: frame 0 moved 1.5 forward, and every other edge into it, so
    that part of frame i lands at z < MIN_DEPTH."""
    from goslam_tpu_torch.ops import lie, projective
    dev = "cuda"
    xi = torch.randn((P, 6), generator=gen) * 0.05
    poses = lie.exp(xi)
    disps = (0.3 + 0.5 * torch.rand((P, ht8, wd8), generator=gen)).to(dev)
    intr = torch.tensor([0.9 * wd8, 0.9 * wd8, wd8 / 2 - 0.5,
                         ht8 / 2 - 0.5]).to(dev)
    ii = torch.randint(0, P, (E,), generator=gen)
    jj = (ii + torch.randint(1, 4, (E,), generator=gen)) % P
    valid = torch.rand(E, generator=gen) > 0.125
    if kind == "stereo":
        jj[::4] = ii[::4]
    elif kind == "invalid":
        valid[:] = False
    elif kind == "behind":
        poses[0, 2] -= 1.5
        jj[::2] = 0
        ii[::2] = torch.where(ii[::2] == 0, 1, ii[::2])
    elif kind != "path":
        raise ValueError(kind)
    poses, ii, jj, valid = poses.to(dev), ii.to(dev), jj.to(dev), \
        valid.to(dev)
    coords, _ = projective.transform(poses, disps, intr, ii, jj)
    target = coords + torch.randn(coords.shape, generator=gen).to(dev)
    weight = torch.rand(coords.shape, generator=gen).to(dev)
    return poses, disps, intr, target, weight, ii, jj, valid


# the edge system's errors at every check: (case, output) -> errors
K1_ERRS = {}


def _scaled_err(a, b):
    """max |a - b| over the largest |b|, and max |a - b|."""
    d = float((a.double() - b.double()).abs().max())
    return d / (float(b.abs().max()) + 1e-12), d


def check_edge_system(gen, E, ht8, wd8, timing: bool, kind: str = "path"):
    from goslam_tpu_torch.ops import dba
    args = edge_problem(gen, E, ht8, wd8, kind=kind)
    out = dba.build_edge_system(*args)
    ref = dba.build_edge_system_plain(*args)
    # an fp64 reference: the plain version on the same inputs in double
    # (its pixel rays (u - cx) / fx are still rounded to fp32 there)
    ref64 = dba.build_edge_system_plain(
        *[a.double() if a.is_floating_point() else a for a in args])
    torch.cuda.synchronize()
    err, rel, worst = 0.0, 0.0, None
    case = f"{kind} E={E} hw={ht8 * wd8}"
    for name, a, b, c in zip(ref._fields, out, ref, ref64):
        if not torch.isfinite(a).all():
            raise SystemExit(f"edge_system {kind}: non-finite {name}")
        r, d = _scaled_err(a, b)
        err = max(err, d)
        if worst is None or r > rel:
            rel, worst = r, name
        # each fp32 version against fp64: how much of the kernel's
        # difference from the plain version is either one's own rounding
        K1_ERRS[case, name] = (r, _scaled_err(a, c)[0], _scaled_err(b, c)[0])
    # fp32 sums over <= 1200 pixels in another order (and with fused
    # multiply-adds): relative to each output's largest entry, 1e-4
    if rel > 1e-4:
        raise SystemExit(f"edge_system {kind} E={E} hw={ht8 * wd8}: "
                         f"relative error {rel:.3g} > 1e-4")
    # no atomics: two launches give the same bits
    again = dba.build_edge_system(*args)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise SystemExit(f"edge_system {kind}: two launches differ")
    # the wrapper never synchronizes: torch raises if it does
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dba.build_edge_system(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res = {"E": E, "hw": ht8 * wd8, "kind": kind, "max_abs_err": err,
           "max_rel_err": rel, "worst_output": worst}
    if timing:
        hw = ht8 * wd8
        # the whole wrapper, captured in a CUDA graph (capture fails if
        # it synchronizes) and replayed; and uncaptured, between events
        res["ms"] = graph_ms(lambda: dba.build_edge_system(*args))
        res["wrapper_ms"] = cuda_ms(lambda: dba.build_edge_system(*args))
        res["plain_ms"] = cuda_ms(lambda: dba.build_edge_system_plain(*args))
        # read once: the disparity rows of the source frames, target and
        # weight per pixel, the poses of the frames the edges touch, ii,
        # jj (int64), valid, intrinsics; written once: H, v, Eii, Eij,
        # Cii, bz
        ii, jj = args[5], args[6]
        n_src = int(torch.unique(ii).numel())
        n_pose = int(torch.unique(torch.cat([ii, jj])).numel())
        nbytes = n_src * hw * 4 + E * hw * (8 + 8) + n_pose * 7 * 4 \
            + E * (8 + 8 + 1) + 16 \
            + E * (144 + 12) * 4 + E * hw * (6 + 6 + 1 + 1) * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, E * hw * K1_FLOP_PER_PX / PEAK_FP32_S)
    return res


# lookup coordinates of the alt-corr checks: the main path's kind, and the
# kinds of tests/test_torch_kernels_ref.py that test the kernel's reduction
# of a 64-pixel tile's windows to the box of target pixels they touch
CORR_KINDS = ("flow", "smooth", "spread", "nan", "far", "tile_out",
              "border")


def alt_corr_coords(gen, kind: str, E: int, ht8: int, wd8: int):
    """flow: the pixel grid moved by noise of 3 px, each pixel its own;
    smooth: the grid moved by one shift per edge; spread: uniform over
    the frame and a margin; nan: some x, some y, some both NaN; far: some
    coordinates at +-1e6; tile_out: the first 64 pixels of every edge with
    windows that miss the image at every level; border: values at and
    around the last one whose window still touches the image, on each
    side, at each level."""
    from goslam_tpu_torch.ops import projective
    grid = projective.coords_grid(ht8, wd8)
    c = grid + 3.0 * torch.randn((E, ht8, wd8, 2), generator=gen)
    flat = c.view(-1, 2)
    if kind == "smooth":
        c = grid + 3.0 * torch.randn((E, 1, 1, 2), generator=gen)
    elif kind == "spread":
        size = torch.tensor([wd8, ht8], dtype=torch.float32)
        c = (size + 5) * torch.rand(c.shape, generator=gen) - 3
    elif kind == "nan":
        flat[torch.rand(flat.shape, generator=gen) < 0.08] = float("nan")
    elif kind == "far":
        pick = torch.rand(flat.shape, generator=gen) < 0.3
        sign = torch.randint(0, 2, (int(pick.sum()),), generator=gen) * 2 - 1
        flat[pick] = 1e6 * sign.float()
    elif kind == "tile_out":
        tile = c.view(E, -1, 2)[:, :64]
        tile.copy_(-40 - 160 * torch.rand(tile.shape, generator=gen))
        right = tile[1::2, :, 0]
        right.copy_(8 * (wd8 + 4) + 300 * torch.rand(right.shape,
                                                     generator=gen))
    elif kind == "border":
        for a, size in enumerate((wd8, ht8)):
            vals = torch.tensor([s * 2 ** l + d for l in range(4)
                                 for s in (-4, -3, size + 2, size + 3)
                                 for d in (-0.25, 0.0, 0.25)])
            flat[:, a] = vals[torch.randint(0, len(vals), (flat.shape[0],),
                                            generator=gen)]
    elif kind != "flow":
        raise ValueError(kind)
    return c


def check_alt_corr(gen, E, T, ht8, wd8, timing: bool, kind: str = "flow"):
    from goslam_tpu_torch.ops import corr, kernels
    dev = "cuda"
    fmaps = torch.randn((T, ht8, wd8, 128), generator=gen).to(dev)
    levels = corr.build_feature_pyramid(fmaps)
    ii = torch.randint(0, T, (E,), generator=gen).to(dev)
    jj = torch.randint(0, T, (E,), generator=gen).to(dev)
    coords = alt_corr_coords(gen, kind, E, ht8, wd8).to(dev)
    out = corr.alt_corr(levels, coords, ii, jj)
    ref = corr.alt_corr_plain(levels, coords, ii, jj)
    torch.cuda.synchronize()
    # a NaN coordinate makes its pixel's outputs NaN in both, and nothing
    # else may be NaN or infinite
    nan_px = torch.isnan(coords).any(-1)[..., None].expand_as(ref)
    if not (torch.equal(torch.isnan(out), nan_px)
            and torch.equal(torch.isnan(ref), nan_px)
            and torch.isfinite(out[~nan_px]).all()):
        raise SystemExit(f"alt_corr {kind}: non-finite output where the "
                         f"coordinates are finite, or finite where not")
    d = (out - ref).abs()[~nan_px]
    err = float(d.max())
    # both sum exact bf16 x bf16 products in fp32, in another order
    tol = 1e-4 + 1e-4 * ref[~nan_px].abs()
    if bool((d > tol).any()):
        raise SystemExit(f"alt_corr {kind} E={E} hw={ht8 * wd8}: max error "
                         f"{err:.3g} beyond 1e-4 + 1e-4 |plain|")
    res = {"E": E, "T": T, "hw": ht8 * wd8, "kind": kind,
           "max_abs_err": err}
    if timing:
        kin = corr.alt_corr_kernel_inputs(levels, coords, ii, jj)
        res["ms"] = graph_ms(lambda: kernels.alt_corr(*kin, out))
        res["wrapper_ms"] = cuda_ms(
            lambda: corr.alt_corr(levels, coords, ii, jj))
        res["plain_ms"] = cuda_ms(
            lambda: corr.alt_corr_plain(levels, coords, ii, jj), iters=5)
        # taps inside the image at each level: the dot products the
        # kernel must do for this data
        P1 = ht8 * wd8
        taps = 0
        off = torch.arange(8, device=dev) - 3
        for l, lv in enumerate(levels):
            H2, W2 = lv.shape[1], lv.shape[2]
            c = (coords / 2 ** l).floor().long().reshape(E * P1, 2)
            nx = ((c[:, :1] + off >= 0) & (c[:, :1] + off < W2)).sum(1)
            ny = ((c[:, 1:] + off >= 0) & (c[:, 1:] + off < H2)).sum(1)
            taps += int((nx * ny).sum())
        # the dot products take bf16 inputs: their peak is the tensor
        # cores' bf16 rate; the bilinear combine is fp32
        op_s = taps * 128 * 2 / PEAK_BF16_S \
            + E * P1 * len(levels) * 49 * K2_FLOP_PER_CH / PEAK_FP32_S
        nbytes = sum(lv.numel() * 2 for lv in levels) + coords.numel() * 4 \
            + 2 * E * 4 + out.numel() * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, op_s)
        res["in_bounds_taps"] = taps
    return res


def schur_problem(gen, P: int, E: int, hw: int, n_valid: int,
                  hub_in: int = 0, hub_out: int = 0):
    """Operands of the Schur matvec as loop-160's global BA lays them
    out: n_valid of the E edge slots hold edges, whose source frames are
    the first 5/6 of the window (160 keyframes in a window of 192; the
    frames past them have no edges).  `hub_in` of the edges go into
    frame 0 and the next `hub_out` leave frame 1.  Returns the operands
    of dba.schur_matvec, scratch excepted."""
    from goslam_tpu_torch.ops import dba
    dev = "cuda"
    used = max(1, P * 5 // 6)
    valid = torch.zeros(E, dtype=torch.bool)
    valid[torch.randperm(E, generator=gen)[:n_valid]] = True
    ii = torch.randint(0, used, (E,), generator=gen)
    jj = torch.randint(0, used, (E,), generator=gen)
    picked = torch.nonzero(valid)[:, 0]
    jj[picked[:hub_in]] = 0
    ii[picked[hub_in:hub_in + hub_out]] = 1
    plan = dba.schur_plan(ii.to(dev), jj.to(dev), valid.to(dev), P)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    return (rnd(P, 6), rnd(P, 6, hw), torch.rand((P, hw), generator=gen).to(dev),
            rnd(E, 12, 12), rnd(E, 6, hw).to(torch.bfloat16),
            jj.to(dev)[plan.order].to(torch.int32).contiguous(), plan.rowptr,
            plan.colptr, plan.cidx)


def check_schur_matvec(gen, P, E, hw, n_valid, timing: bool,
                       hub_in: int = 0, hub_out: int = 0):
    from goslam_tpu_torch.ops import dba
    args = schur_problem(gen, P, E, hw, n_valid, hub_in, hub_out)
    work = dba.schur_work(P, E, "cuda")
    out = dba.schur_matvec(*args, work=work).clone()
    ref = dba.schur_matvec_plain(*args[:7])
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise SystemExit("schur_matvec: non-finite output")
    err = float((out - ref).abs().max())
    rel = err / (float(ref.abs().max()) + 1e-12)
    # the same bf16-rounded Eij in both; fp32 sums over hw pixels and a
    # frame's edges in another order: 1e-4 of the output's largest entry
    if rel > 1e-4:
        raise SystemExit(f"schur_matvec P={P} E={E} hw={hw}: relative "
                         f"error {rel:.3g} > 1e-4")
    # no atomics in the matvec, scatter to jj included: two launches give
    # the same bits
    again = dba.schur_matvec(*args, work=dba.schur_work(P, E, "cuda"))
    if not torch.equal(out, again):
        raise SystemExit("schur_matvec: two launches differ")
    res = {"P": P, "E": E, "hw": hw, "n_valid": n_valid,
           "hub_in": hub_in, "hub_out": hub_out,
           "max_abs_err": err, "max_rel_err": rel}
    if timing:
        # the whole matvec: one launch, scatter to jj included
        res["ms"] = graph_ms(lambda: dba.schur_matvec(*args, work=work))
        res["wrapper_ms"] = cuda_ms(lambda: dba.schur_matvec(*args,
                                                             work=work))
        res["plain_ms"] = cuda_ms(lambda: dba.schur_matvec_plain(*args[:7]))
        # read once: x, Ei, Q, rowptr, and H, Eij (bf16), jj of the valid
        # edges; written once: yf and oc
        nbytes = P * 6 * 4 + P * 6 * hw * 4 + P * hw * 4 + (P + 1) * 4 \
            + n_valid * (144 * 4 + 6 * hw * 2 + 4) + P * 6 * 4 + E * 6 * 4
        # a multiply-add per Ei and Eij entry in each of the two passes,
        # the Q scaling, and the 12x12 product per edge
        flop = 2 * 2 * 6 * hw * (P + n_valid) + P * hw + n_valid * 2 * 144
        res["bound_ms"], res["bound_by"] = bound(nbytes, flop / PEAK_FP32_S)
    return res


def check_cg_vs_chol(ht8: int, wd8: int, P: int = 192):
    """dba.ba with solver="cg" (the schur_matvec kernel inside PCG)
    against solver="chol" on one seeded band graph of P poses, the
    problem of tests/test_dba.py: a chain of poses, every frame tied to
    its three neighbours on each side, targets from the true scene, a
    perturbed start, two Gauss-Newton steps in the global-BA damping
    regime.  PCG runs with the budget global BA gives it (32 iterations
    per step) and with one that lets it converge (256)."""
    from goslam_tpu_torch.ops import dba, lie, projective
    dev = "cuda"
    gen = torch.Generator().manual_seed(11)
    xi = torch.cumsum(0.02 * torch.randn((P, 6), generator=gen), dim=0)
    poses_gt = lie.exp(xi).to(dev)
    disps = (0.5 + 0.2 * torch.rand((P, ht8, wd8), generator=gen)).to(dev)
    intr = torch.tensor([0.9 * wd8, 0.9 * wd8, wd8 / 2 - 0.5,
                         ht8 / 2 - 0.5]).to(dev)
    k = torch.arange(P)
    keep = (k[:, None] != k[None, :]) & ((k[:, None] - k[None, :]).abs() <= 3)
    ii, jj = [t.to(dev) for t in torch.nonzero(keep, as_tuple=True)]
    E = ii.shape[0]
    target, _ = projective.transform(poses_gt, disps, intr, ii, jj)
    xi_p = 0.02 * torch.randn((P, 6), generator=gen)
    xi_p[0] = 0
    poses0 = lie.compose(lie.exp(xi_p).to(dev), poses_gt)
    args = (poses0, disps, intr, torch.zeros_like(disps), target,
            torch.ones((E, ht8, wd8, 2), device=dev),
            torch.full_like(disps, 1e-4), ii, jj,
            torch.ones(E, dtype=torch.bool, device=dev), 1, P)
    kw = dict(iters=2, lm=1e-5, ep=1e-2, max_deg=8)

    def pose_err(a):
        return float((lie.rel(a[:1].expand_as(a), a)[:, :3]
                      - lie.rel(poses_gt[:1].expand_as(a),
                                poses_gt)[:, :3]).abs().max())

    p_ch, d_ch = dba.ba(*args, solver="chol", **kw)
    res = {"P": P, "E": E, "hw": ht8 * wd8, "err_start": pose_err(poses0),
           "err_chol": pose_err(p_ch)}
    for budget in (32, 256):
        p_cg, d_cg = dba.ba(*args, solver="cg", cg_iters=budget, **kw)
        if not (torch.isfinite(p_cg).all() and torch.isfinite(d_cg).all()):
            raise SystemExit(f"cg vs chol: non-finite PCG result {res}")
        res[f"err_cg{budget}"] = pose_err(p_cg)
        res[f"pose_diff_cg{budget}"] = float((p_cg - p_ch).abs().max())
        res[f"disp_diff_cg{budget}"] = float((d_cg - d_ch).abs().max())
    torch.cuda.synchronize()
    # Cholesky cuts the start error to a quarter (tests/test_dba.py); the
    # converged PCG lands on its solution up to the bf16 rounding of Eij
    # (~0.4 % of the operator) and the PCG tolerance
    if not (res["err_chol"] < 0.25 * res["err_start"]
            and res["pose_diff_cg256"] < CG_CHOL_POSE_TOL
            and res["disp_diff_cg256"] < CG_CHOL_DISP_TOL):
        raise SystemExit(f"cg vs chol at P={P} disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def accuracy_config(ht: int, wd: int):
    """tests/test_accuracy.py's configuration."""
    from goslam_tpu_torch.config import default_config, update_recursive
    cfg = default_config()
    update_recursive(cfg, {
        "dataset": "synthetic", "mode": "rgbd",
        "cam": {"H": ht, "W": wd, "H_out": ht, "W_out": wd,
                "H_edge": 0, "W_edge": 0},
        "data": {"input_folder": "", "n_frames": 40, "output": "",
                 "room_half_size": 3.0},
        "tracking": {
            "buffer": 64, "warmup": 4,
            "motion_filter": {"thresh": 2.0},
            "frontend": {"window": 8, "max_factors": 32,
                         "enable_loop": False, "keyframe_thresh": 1.0},
            "global_ba_every": 10,
        },
    })
    return cfg


def loop_config(ht: int, wd: int, enable_loop: bool = True):
    """loop-160: two laps of the accuracy configuration's orbit at its
    angle per frame (160 frames, orbit_fraction 2.0), so that lap two
    revisits lap one, with the loop-closing settings of
    tests/test_loop_closure.py.  About 160 keyframes: from the 129th on,
    global BA and loop closing work on a window of 192 poses and solve
    with PCG."""
    from goslam_tpu_torch.config import update_recursive
    return update_recursive(accuracy_config(ht, wd), {
        "data": {"n_frames": 160, "orbit_fraction": 2.0},
        "tracking": {
            "buffer": 256,
            "frontend": {"enable_loop": enable_loop},
            "backend": {"loop_window": 25, "loop_thresh": 30.0,
                        "loop_radius": 1, "loop_nms": 2},
        },
    })


# name -> (config, ATE gate or None, kernels that must have been launched,
# fewest keyframes)
PATHS = {
    "accuracy-128": (lambda: accuracy_config(128, 192), 0.18,
                     ("edge_system", "alt_corr"), 0),
    "accuracy-240": (lambda: accuracy_config(240, 320), 0.25,
                     ("edge_system", "alt_corr"), 0),
    "loop-160": (lambda: loop_config(128, 192), LOOP_ATE_GATE,
                 ("edge_system", "alt_corr", "schur_matvec"), 129),
    "loop-160-off": (lambda: loop_config(128, 192, False), None,
                     ("edge_system", "alt_corr", "schur_matvec"), 129),
    "loop-160-240": (lambda: loop_config(240, 320), None,
                     ("edge_system", "alt_corr", "schur_matvec"), 129),
}


class ShapeRecorder:
    """Counts the shapes each kernel is launched at while installed: the
    launch functions of ops/kernels.py are wrapped for the duration of
    one run and restored after it.  For the Schur matvec it also keeps
    the largest number of valid edges seen at each shape (one scalar read
    from the device per launch)."""

    def __init__(self):
        from goslam_tpu_torch.ops import kernels
        self.kernels = kernels
        self.shapes = {"edge_system": {}, "alt_corr": {}, "schur_matvec": {}}
        self.schur_valid = {}

    def _count(self, name, key):
        self.shapes[name][key] = self.shapes[name].get(key, 0) + 1

    def __enter__(self):
        k = self.kernels
        self._orig = (k.edge_system, k.alt_corr, k.schur_matvec)
        es, ac, sm = self._orig

        def edge_system(poses, disps, intr, target, *rest):
            self._count("edge_system", (target.shape[0],           # (E, hw)
                                        disps.shape[1] * disps.shape[2]))
            return es(poses, disps, intr, target, *rest)

        def alt_corr(levels, coords, *rest):
            E, h, w, _ = coords.shape
            self._count("alt_corr", (E, levels[0].shape[0], h * w))
            return ac(levels, coords, *rest)

        def schur_matvec(x, Ei, Q, H, Eij, jj, rowptr, *rest):
            key = (Ei.shape[0], Eij.shape[0], Ei.shape[2])        # (P, E, hw)
            self._count("schur_matvec", key)
            self.schur_valid[key] = max(self.schur_valid.get(key, 0),
                                        int(rowptr[-1]))
            return sm(x, Ei, Q, H, Eij, jj, rowptr, *rest)

        k.edge_system, k.alt_corr, k.schur_matvec = (edge_system, alt_corr,
                                                     schur_matvec)
        return self

    def __exit__(self, *exc):
        k = self.kernels
        k.edge_system, k.alt_corr, k.schur_matvec = self._orig


def sync_sites(fn):
    """Run fn() once with torch's sync debug mode at "warn" and count the
    host synchronizations it makes: (count, {"file:line": count}), each
    site the innermost line of this repository on the warning's stack."""
    sites = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost line of the port, else of this script
        stack = [f for f in traceback.extract_stack()[:-1]
                 if f.filename.startswith(ROOT + os.sep)]
        here = [f for f in stack if not f.filename.endswith("chip_smoke.py")]
        if filename.startswith(ROOT + os.sep):
            site = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        elif here or stack:
            f = (here or stack)[-1]
            site = f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} " \
                f"(in {os.path.basename(filename)}:{lineno})"
        else:
            site = f"{filename}:{lineno}"
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(sites.values()), dict(sorted(sites.items(),
                                            key=lambda kv: -kv[1]))


def count_syncs(slam):
    """The host synchronizations left in one frontend step
    (FactorGraph.update, as the frontend calls it) and in the one dba.ba
    call inside it, replayed on copies of its arguments."""
    from goslam_tpu_torch.ops import dba
    graph = slam.frontend.graph
    captured = []
    ba = dba.ba

    def recording_ba(*a, **k):
        captured.append(([x.clone() if torch.is_tensor(x) else x
                          for x in a], dict(k)))
        return ba(*a, **k)

    dba.ba = recording_ba
    try:
        n_step, step_sites = sync_sites(
            lambda: graph.update(use_inactive=True))
    finally:
        dba.ba = ba
    a, k = captured[-1]
    n_ba, ba_sites = sync_sites(lambda: dba.ba(*a, **k))
    return {"frontend_update": {"count": n_step, "sites": step_sites},
            "ba": {"count": n_ba, "sites": ba_sites,
                   "E": int(a[7].shape[0]), "P": int(a[0].shape[0]),
                   "iters": k.get("iters")}}


class PhaseTimer:
    """Wall time of the system's phases (motion filter, frontend, global
    BA, loop closing, the PCG solves inside them, trajectory filler), each
    ended by a device synchronize, and the PCG solves' iteration counts;
    installed for one timed run.  Phases nest: a frontend update
    contains its loop closing, which contains its PCG solves."""

    def __init__(self, slam):
        from goslam_tpu_torch.ops import dba
        self.totals = {}
        self.pcg_solves = 0
        self.pcg_iterations = 0
        self._dba = dba
        self._cg_solve = dba._cg_solve
        for name, obj, attr in (("motion_filter", slam.motion_filter, "track"),
                                ("frontend", slam.frontend, "_update"),
                                ("frontend_init", slam.frontend, "_initialize"),
                                ("global_ba", slam.backend, "dense_ba"),
                                ("loop_ba", slam.backend, "loop_ba"),
                                ("traj_filler", slam.traj_filler,
                                 "_fill_batch")):
            setattr(obj, attr, self._wrap(name, getattr(obj, attr)))
        timed_solve = self._wrap("pcg_solve", dba._cg_solve)

        def cg_solve(*a, **k):
            dx, iterations = timed_solve(*a, **k)
            self.pcg_solves += 1
            self.pcg_iterations += iterations
            return dx, iterations

        dba._cg_solve = cg_solve

    def close(self):
        self._dba._cg_solve = self._cg_solve

    def _wrap(self, name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.totals[name] = self.totals.get(name, 0.0) \
                + time.perf_counter() - t0
            return out
        return timed


def run_path(name: str, out_dir: str, phases: bool = False,
             trace: bool = False, syncs: bool = False):
    """Drive one path through SLAMSystem.track / terminate and check what
    comes out: finite poses of the expected shape, the path's ATE gate,
    its fewest keyframes, its kernels launched.  `phases` times the
    system's phases (a device synchronize around each), `trace` runs
    under torch.profiler; both slow the run, so they are separate.
    `syncs` counts, after the run, the host synchronizations of one more
    frontend step and of its dba.ba call (count_syncs)."""
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.ops import kernels
    from goslam_tpu_torch.system import SLAMSystem

    make_cfg, gate, must_launch, min_keyframes = PATHS[name]
    cfg = make_cfg()
    ht, wd = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    ds = Synthetic(cfg)
    frames = [ds[i] for i in range(len(ds))]
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT), output=out_dir,
                      only_tracking=True)
    timer = PhaseTimer(slam) if phases else None

    def stream():
        for i, (_, img, depth, intr, gt) in enumerate(frames):
            yield float(i), img, depth, intr, gt

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity
        # the device's events only: with the host's operators too, a
        # path of 160 frames takes many minutes to summarize
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    # what earlier runs left behind is freed first; what stays allocated
    # (the model's weights, the frames) is reported beside the peak
    gc.collect()
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with ShapeRecorder() as rec:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (_, img, depth, intr, gt) in enumerate(frames):
            slam.track(float(i), img, depth, intr, gt)
        torch.cuda.synchronize()
        t_track = time.perf_counter() - t0
        metrics = slam.terminate(stream=stream())
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    if prof is not None:
        prof.__exit__(None, None, None)
    if timer is not None:
        timer.close()

    n = slam.video.counter
    poses = slam.video.poses[:n]
    est = np.load(os.path.join(out_dir, "est_poses.npy"))
    if not (bool(torch.isfinite(poses).all()) and np.isfinite(est).all()):
        raise SystemExit(f"{name}: non-finite poses")
    if est.shape != (len(frames), 4, 4):
        raise SystemExit(f"{name}: trajectory of shape {est.shape}")
    res = {
        "path": name, "ht": ht, "wd": wd, "frames": len(frames),
        "keyframes": n,
        "ate_rmse": metrics["ate"]["rmse"], "ate_scale": metrics["ate"]["scale"],
        "track_s": t_track, "total_s": t_total,
        "tracked_fps": len(frames) / t_track, "launches": launches,
        "loop_accepts": slam.backend.total_loop_accepts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mem_at_start_gb": mem_at_start / 1e9,
        "shapes": {k: sorted(v.items(), key=lambda kv: -kv[1])
                   for k, v in rec.shapes.items()},
        "schur_valid": sorted(rec.schur_valid.items()),
    }
    if phases:
        res["phases_s"] = timer.totals
        res["pcg"] = {"solves": timer.pcg_solves,
                      "iterations": timer.pcg_iterations}
    if trace:
        res["profile"] = summarize_profile(prof, t_total, out_dir)
    if syncs:
        res["syncs"] = count_syncs(slam)
        print(f"host syncs {name}: {json.dumps(res['syncs'])}", flush=True)

    kind = "timed " if phases else "traced " if trace else ""
    say(f"{kind}path {name}: {json.dumps(res)}")
    ref = f" (JAX on a TPU v5e: {JAX_ATE_128} m)" \
        if name == "accuracy-128" else ""
    print(f"  {name}: {n} keyframes, ATE {res['ate_rmse']:.4f} m{ref}, scale "
          f"{res['ate_scale']:.3f}, {res['tracked_fps']:.2f} tracked "
          f"frames/s, {res['total_s']:.1f} s in all, kernels {launches}, "
          f"loop candidates accepted {res['loop_accepts']}", flush=True)
    if gate is not None and not res["ate_rmse"] < gate:
        raise SystemExit(f"{name}: ATE {res['ate_rmse']} >= {gate}")
    if n < min_keyframes:
        raise SystemExit(f"{name}: {n} keyframes, fewer than the "
                         f"{min_keyframes} at which global BA reaches the "
                         f"PCG solver: the run proves nothing")
    for kernel in must_launch:
        if launches[kernel] <= 0:
            raise SystemExit(f"{name}: kernel {kernel} was not launched")
    if cfg["tracking"]["frontend"]["enable_loop"] \
            and res["loop_accepts"] <= 0:
        raise SystemExit(f"{name}: no loop candidate passed the vote")
    return res


def summarize_profile(prof, wall_s: float, out_dir: str):
    """Device busy time (the sum of the device time of every kernel and
    copy, one stream) over the run's wall time, and the largest kernels;
    the full table goes to <out_dir>/profile.txt."""
    from torch.autograd import DeviceType

    # kernels and copies only, not the runtime calls that launched them
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total",
                               row_limit=60))
    return {
        "device_busy_s": busy_us / 1e6, "wall_s": wall_s,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "top_kernels_ms": [(e.key[:60], e.self_device_time_total / 1e3,
                            e.count) for e in top],
    }


KERNELS = (
    ("edge_system", "goslam_tpu_torch/csrc/edge_system.cu",
     "goslam_tpu/ops/pallas_kernels.py:43", "accuracy-128"),
    ("alt_corr", "goslam_tpu_torch/csrc/alt_corr.cu",
     "goslam_tpu/ops/pallas_corr.py:70", "accuracy-128"),
    ("schur_matvec", "goslam_tpu_torch/csrc/schur_matvec.cu",
     "goslam_tpu/ops/pallas_kernels.py:281", "loop-160"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", action="store_true",
                        help="add two more runs each of accuracy-128 and "
                             "loop-160: one with phase times and PCG "
                             "iterations, one under torch.profiler (device "
                             "idle share, largest kernels)")
    parser.add_argument("--paths", default=",".join(PATHS),
                        help="comma-separated paths to drive (default: "
                             "all); the result line is printed only when "
                             "all of them ran")
    parser.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                        help="directory for the trajectories and the "
                             "profile table")
    args = parser.parse_args(argv)
    names = [n for n in args.paths.split(",") if n]
    for n in names:
        if n not in PATHS:
            parser.error(f"unknown path {n!r}; known: {', '.join(PATHS)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from goslam_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_start = time.perf_counter()
    paths = kernels.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for p in paths.values():
        with open(p + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)
                if spills and spills.groups() != ("0", "0"):
                    raise SystemExit(f"register spills in {p}: {line}")

    gen = torch.Generator().manual_seed(0)
    # edge_system at the main path's form and at adversarial inputs:
    # stereo edges, every edge invalid, E=1, pixels behind MIN_DEPTH, a
    # ragged 7x11 frame, E=1024 at 30x40
    for kind, E, h8, w8 in (("path", 16, 8, 12), ("stereo", 64, 16, 24),
                            ("invalid", 64, 16, 24), ("path", 1, 16, 24),
                            ("behind", 64, 16, 24), ("path", 40, 7, 11),
                            ("stereo", 40, 7, 11), ("behind", 40, 7, 11),
                            ("behind", 160, 30, 40),
                            ("path", 1024, 30, 40)):
        print("small check edge_system:",
              check_edge_system(gen, E, h8, w8, False, kind), flush=True)
    # alt_corr at every kind of coordinates, at pixel counts that are no
    # multiple of its 64-pixel tile (96 and 300, four levels)
    for kind in CORR_KINDS:
        for E, T, h8, w8 in ((8, 4, 8, 12), (4, 6, 15, 20)):
            print("small check alt_corr:",
                  check_alt_corr(gen, E, T, h8, w8, False, kind), flush=True)
    # schur_matvec with frames of degree 0 (past the first 5/6), a hub
    # frame that 40 edges point into, one that 60 edges leave (more than
    # the block has warps), and hw = 100, no multiple of 8
    for P, E, hw, n_valid, hub_in, hub_out in ((16, 64, 96, 50, 0, 0),
                                               (48, 128, 96, 100, 40, 0),
                                               (48, 128, 96, 100, 0, 60),
                                               (48, 128, 100, 110, 40, 60)):
        print("small check schur_matvec:",
              check_schur_matvec(gen, P, E, hw, n_valid, False, hub_in,
                                 hub_out), flush=True)
    for ht8, wd8 in ((8, 12), (16, 24)):
        res = check_cg_vs_chol(ht8, wd8)
        say(f"cg vs chol: {json.dumps(res)}")
        if ht8 == 8 and not res["err_cg32"] < CG32_LAG * res["err_chol"]:
            raise SystemExit(f"PCG with 32 iterations lags Cholesky by more "
                             f"than {CG32_LAG}x: {res}")

    runs = {}
    for name in names:
        runs[name] = run_path(name, os.path.join(args.out, name),
                              syncs=name == "accuracy-128")
    if "loop-160" in runs and "loop-160-off" in runs:
        print(f"loop-160 ATE with loop closing "
              f"{runs['loop-160']['ate_rmse']:.4f} m, without "
              f"{runs['loop-160-off']['ate_rmse']:.4f} m", flush=True)
    if args.profile:
        for name in ("accuracy-128", "loop-160"):
            if name in runs:
                run_path(name, os.path.join(args.out, f"profile-{name}"),
                         phases=True)
                run_path(name, os.path.join(args.out, f"profile-{name}"),
                         trace=True)

    # every kernel at every shape a path gave it, timed
    checked = {"edge_system": {}, "alt_corr": {}, "schur_matvec": {}}
    for r in runs.values():
        h8, w8 = r["ht"] // 8, r["wd"] // 8
        for (E, hw), count in r["shapes"]["edge_system"]:
            if (hw, E) not in checked["edge_system"]:
                res = check_edge_system(gen, E, h8, w8, True)
                checked["edge_system"][(hw, E)] = res
                say(f"edge_system {json.dumps(res)}")
        for (E, T, hw), count in r["shapes"]["alt_corr"]:
            if (hw, E, T) not in checked["alt_corr"]:
                res = check_alt_corr(gen, E, T, h8, w8, True)
                checked["alt_corr"][(hw, E, T)] = res
                say(f"alt_corr {json.dumps(res)}")
        for (P, E, hw), n_valid in r["schur_valid"]:
            if (hw, P, E) not in checked["schur_matvec"]:
                res = check_schur_matvec(gen, P, E, hw, n_valid, True)
                checked["schur_matvec"][(hw, P, E)] = res
                say(f"schur_matvec {json.dumps(res)}")
    say("all kernels checked at every shape")
    # the edge system's accuracy per output: its worst relative error
    # against the plain version over every case above, and the kernel's
    # and the plain version's against fp64 at that case
    acc = {}
    for (case, name), errs in K1_ERRS.items():
        if name not in acc or errs[0] > acc[name]["vs_plain"]:
            acc[name] = {"case": case, "vs_plain": errs[0],
                         "kernel_vs_fp64": errs[1], "plain_vs_fp64": errs[2]}
    for name in acc:
        cases = [e for (c, n), e in K1_ERRS.items() if n == name]
        acc[name]["worst_kernel_vs_fp64"] = max(e[1] for e in cases)
        acc[name]["worst_plain_vs_fp64"] = max(e[2] for e in cases)
    print(f"edge_system accuracy: {json.dumps(acc)}", flush=True)
    # device time each kernel loses per run of the driven paths: at every
    # shape a path gave it, launches x (time - bound)
    lost = {name: 0.0 for name in checked}
    for r in runs.values():
        for name in checked:
            for shape, count in r["shapes"][name]:
                res = checked[name][(shape[-1],) + tuple(shape[:-1])]
                lost[name] += count * (res["ms"] - res["bound_ms"])
    print(f"lost per run, ms (launches x (ms - bound_ms) over "
          f"{', '.join(runs)}): {json.dumps(lost)}", flush=True)

    if set(names) != set(PATHS):
        print("not all paths were driven: no result line", file=sys.stderr)
        return 1

    # the line of kernels: each kernel's launches on its path, and its
    # times at the shape that path launched it at most often
    entries = []
    for name, src, tpu, path in KERNELS:
        run = runs[path]
        shape = run["shapes"][name][0][0]
        hw = shape[-1]
        key = (hw,) + tuple(shape[:-1])
        res = checked[name][key]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "path": path, "shape": list(shape),
            "launches": run["launches"][name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in checked[name].values()),
            "ms": res["ms"], "wrapper_ms": res["wrapper_ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            # no single PyTorch call computes any of the three functions
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
