#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (goslam_tpu_torch) on one GPU.

    python3 chip_smoke.py              # everything, as a check on the card
    python3 chip_smoke.py --profile    # also a profiled 128x192 run

Phases, each of which exits non-zero on failure (nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     goslam_tpu_torch/csrc with nvcc (one process per source, in parallel);
  2. check each kernel against its plain PyTorch version at a small shape;
  3. the main path: RGB-D tracking only on the synthetic scene at 128x192,
     40 frames, with checkpoints/droid_synthetic.ckpt, through
     SLAMSystem.track / terminate.  Gates: every pose finite, ATE < 0.18 m,
     and every kernel of the path launched (counts reset just before the
     run, read just after).  The shapes each kernel was launched at are
     recorded;
  4. the same path at 240x320 (gates: finite, ATE < 0.25 m);
  5. each kernel against its plain version at every shape the main path
     gave it, with the kernel's device time (CUDA graph replay), the
     wrapper's and the plain version's time, and the bound (the least
     time the card could take for the same work) from this run's inputs.

The second line from the end is a JSON object listing the kernels, the
line before it the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device; exits non-zero
without printing a result when there is none.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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

# fp32 operations per pixel of the edge-system kernel, counted from
# csrc/edge_system.cu: the warp and projection (~40), the two 6-row
# Jacobians and their adjoint transport (~110), the 78+12 Gram entries
# for the u and v rows (4 each, 360), the couplings and depth terms (~50)
K1_FLOP_PER_PX = 560
# per output channel of alt-corr: the 4-tap bilinear combine (fp32)
K2_FLOP_PER_CH = 11


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

def edge_problem(gen, E: int, ht8: int, wd8: int, P: int = 24):
    """Inputs of the edge-system kernel in the main path's form: poses
    near identity, disparities 0.3-0.8, targets near the reprojection,
    one in eight edge slots invalid (padding)."""
    from goslam_tpu_torch.ops import lie, projective
    dev = "cuda"
    xi = torch.randn((P, 6), generator=gen) * 0.05
    poses = lie.exp(xi).to(dev)
    disps = (0.3 + 0.5 * torch.rand((P, ht8, wd8), generator=gen)).to(dev)
    intr = torch.tensor([0.9 * wd8, 0.9 * wd8, wd8 / 2 - 0.5,
                         ht8 / 2 - 0.5]).to(dev)
    ii = torch.randint(0, P, (E,), generator=gen)
    jj = (ii + torch.randint(1, 4, (E,), generator=gen)) % P
    ii, jj = ii.to(dev), jj.to(dev)
    valid = (torch.rand(E, generator=gen) > 0.125).to(dev)
    coords, _ = projective.transform(poses, disps, intr, ii, jj)
    target = coords + torch.randn(coords.shape, generator=gen).to(dev)
    weight = torch.rand(coords.shape, generator=gen).to(dev)
    return poses, disps, intr, target, weight, ii, jj, valid


def check_edge_system(gen, E, ht8, wd8, timing: bool):
    from goslam_tpu_torch.ops import dba, kernels
    args = edge_problem(gen, E, ht8, wd8)
    out = dba.build_edge_system(*args)
    ref = dba.build_edge_system_plain(*args)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for name, a, b in zip(ref._fields, out, ref):
        if not torch.isfinite(a).all():
            raise SystemExit(f"edge_system: non-finite {name}")
        d = float((a - b).abs().max())
        scale = float(b.abs().max()) + 1e-12
        err, rel = max(err, d), max(rel, d / scale)
    # fp32 sums over <= 1200 pixels in another order (and with fused
    # multiply-adds): relative to each output's largest entry, 1e-4
    if rel > 1e-4:
        raise SystemExit(f"edge_system E={E} hw={ht8 * wd8}: relative "
                         f"error {rel:.3g} > 1e-4")
    res = {"E": E, "hw": ht8 * wd8, "max_abs_err": err, "max_rel_err": rel}
    if timing:
        hw = ht8 * wd8
        kin = dba.edge_kernel_inputs(*args)
        res["ms"] = graph_ms(lambda: kernels.edge_system(*kin, *out))
        res["wrapper_ms"] = cuda_ms(lambda: dba.build_edge_system(*args))
        res["plain_ms"] = cuda_ms(lambda: dba.build_edge_system_plain(*args))
        # read once: disparity, target, weight per pixel, Gij per edge;
        # written once: H, v, Eii, Eij, Cii, bz
        nbytes = E * hw * (4 + 8 + 8) + E * 8 * 4 + 16 \
            + E * (144 + 12) * 4 + E * hw * (6 + 6 + 1 + 1) * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, E * hw * K1_FLOP_PER_PX / PEAK_FP32_S)
    return res


def check_alt_corr(gen, E, T, ht8, wd8, timing: bool):
    from goslam_tpu_torch.ops import corr, kernels, projective
    dev = "cuda"
    fmaps = torch.randn((T, ht8, wd8, 128), generator=gen).to(dev)
    levels = corr.build_feature_pyramid(fmaps)
    ii = torch.randint(0, T, (E,), generator=gen).to(dev)
    jj = torch.randint(0, T, (E,), generator=gen).to(dev)
    grid = projective.coords_grid(ht8, wd8, dev)
    coords = grid + 3.0 * torch.randn((E, ht8, wd8, 2),
                                      generator=gen).to(dev)
    out = corr.alt_corr(levels, coords, ii, jj)
    ref = corr.alt_corr_plain(levels, coords, ii, jj)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise SystemExit("alt_corr: non-finite output")
    d = (out - ref).abs()
    err = float(d.max())
    # both sum exact bf16 x bf16 products in fp32, in another order
    tol = 1e-4 + 1e-4 * ref.abs()
    if bool((d > tol).any()):
        raise SystemExit(f"alt_corr E={E} hw={ht8 * wd8}: max error "
                         f"{err:.3g} beyond 1e-4 + 1e-4 |plain|")
    res = {"E": E, "T": T, "hw": ht8 * wd8, "max_abs_err": err}
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


class ShapeRecorder:
    """Counts the shapes each kernel is launched at while installed: the
    launch functions of ops/kernels.py are wrapped for the duration of
    one main-path run and restored after it."""

    def __init__(self):
        from goslam_tpu_torch.ops import kernels
        self.kernels = kernels
        self.shapes = {"edge_system": {}, "alt_corr": {}}

    def _count(self, name, key):
        self.shapes[name][key] = self.shapes[name].get(key, 0) + 1

    def __enter__(self):
        k = self.kernels
        self._orig = (k.edge_system, k.alt_corr)
        es, ac = self._orig

        def edge_system(d_i, *rest):
            self._count("edge_system", tuple(d_i.shape))          # (E, hw)
            return es(d_i, *rest)

        def alt_corr(levels, coords, *rest):
            E, h, w, _ = coords.shape
            self._count("alt_corr", (E, levels[0].shape[0], h * w))
            return ac(levels, coords, *rest)

        k.edge_system, k.alt_corr = edge_system, alt_corr
        return self

    def __exit__(self, *exc):
        self.kernels.edge_system, self.kernels.alt_corr = self._orig


class PhaseTimer:
    """Wall time of the system's phases (motion filter, frontend, global
    BA, trajectory filler), each ended by a device synchronize; installed
    on one SLAMSystem instance for a profiled run."""

    def __init__(self, slam):
        self.totals = {}
        for name, obj, attr in (("motion_filter", slam.motion_filter, "track"),
                                ("frontend", slam.frontend, "_update"),
                                ("frontend_init", slam.frontend, "_initialize"),
                                ("global_ba", slam.backend, "dense_ba"),
                                ("traj_filler", slam.traj_filler,
                                 "_fill_batch")):
            setattr(obj, attr, self._wrap(name, getattr(obj, attr)))

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


def run_main_path(ht: int, wd: int, out_dir: str, profile: bool = False):
    from goslam_tpu_torch.data.synthetic import Synthetic
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.ops import kernels
    from goslam_tpu_torch.system import SLAMSystem

    cfg = accuracy_config(ht, wd)
    ds = Synthetic(cfg)
    frames = [ds[i] for i in range(len(ds))]
    slam = SLAMSystem(cfg, state_dict=load_checkpoint(CKPT), output=out_dir,
                      only_tracking=True)
    phases = PhaseTimer(slam) if profile else None

    def stream():
        for i, (_, img, depth, intr, gt) in enumerate(frames):
            yield float(i), img, depth, intr, gt

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
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

    n = slam.video.counter
    poses = slam.video.poses[:n]
    est = np.load(os.path.join(out_dir, "est_poses.npy"))
    if not (bool(torch.isfinite(poses).all()) and np.isfinite(est).all()):
        raise SystemExit(f"{ht}x{wd}: non-finite poses")
    if est.shape != (len(frames), 4, 4):
        raise SystemExit(f"{ht}x{wd}: trajectory of shape {est.shape}")
    res = {
        "ht": ht, "wd": wd, "frames": len(frames), "keyframes": n,
        "ate_rmse": metrics["ate"]["rmse"], "ate_scale": metrics["ate"]["scale"],
        "track_s": t_track, "total_s": t_total,
        "tracked_fps": len(frames) / t_track, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "shapes": {k: sorted(v.items(), key=lambda kv: -kv[1])
                   for k, v in rec.shapes.items()},
    }
    if profile:
        res["phases_s"] = phases.totals
        res["profile"] = summarize_profile(prof, t_total, out_dir)
    return res


def summarize_profile(prof, wall_s: float, out_dir: str):
    """Device busy time (the sum of the device time of every kernel and
    copy, one stream) over the run's wall time, and the largest kernels;
    the full table goes to <out_dir>/profile.txt."""
    from torch.autograd import DeviceType

    # the device's own events only: a CPU op's device time repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    return {
        "device_busy_s": busy_us / 1e6, "wall_s": wall_s,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "top_kernels_ms": [(e.key[:60], e.self_device_time_total / 1e3,
                            e.count) for e in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", action="store_true",
                        help="add a profiled 128x192 run: phase times, "
                             "device idle share, largest kernels")
    parser.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                        help="directory for the trajectories and the "
                             "profile table")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from goslam_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for p in paths.values():
        with open(p + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())

    gen = torch.Generator().manual_seed(0)
    print("small check edge_system:",
          check_edge_system(gen, 16, 8, 12, False), flush=True)
    print("small check alt_corr:",
          check_alt_corr(gen, 8, 4, 8, 12, False), flush=True)

    runs = []
    out_root = args.out
    for (ht, wd), gate in (((128, 192), 0.18), ((240, 320), 0.25)):
        r = run_main_path(ht, wd, os.path.join(out_root, f"{ht}x{wd}"))
        runs.append(r)
        ref = f" (JAX on a TPU v5e: {JAX_ATE_128} m)" if ht == 128 else ""
        print(f"main path {ht}x{wd}: {json.dumps(r)}", flush=True)
        print(f"  ATE {r['ate_rmse']:.4f} m{ref}, scale "
              f"{r['ate_scale']:.3f}, {r['tracked_fps']:.2f} tracked "
              f"frames/s, kernels {r['launches']}", flush=True)
        if not r["ate_rmse"] < gate:
            raise SystemExit(f"{ht}x{wd}: ATE {r['ate_rmse']} >= {gate}")
        for name, count in r["launches"].items():
            if count <= 0:
                raise SystemExit(f"{ht}x{wd}: kernel {name} was not "
                                 f"launched on the main path")
    if args.profile:
        r = run_main_path(128, 192, os.path.join(out_root, "profile"),
                          profile=True)
        print(f"profiled main path 128x192: {json.dumps(r)}", flush=True)

    # every kernel at every shape the main path gave it, timed
    checked = {"edge_system": {}, "alt_corr": {}}
    for r in runs:
        h8, w8 = r["ht"] // 8, r["wd"] // 8
        for (E, hw), count in r["shapes"]["edge_system"]:
            res = check_edge_system(gen, E, h8, w8, True)
            checked["edge_system"][(r["ht"], E)] = res
            print(f"edge_system {r['ht']}x{r['wd']} ({count} launches): "
                  f"{json.dumps(res)}", flush=True)
        for (E, T, hw), count in r["shapes"]["alt_corr"]:
            res = check_alt_corr(gen, E, T, h8, w8, True)
            checked["alt_corr"][(r["ht"], E, T)] = res
            print(f"alt_corr {r['ht']}x{r['wd']} ({count} launches): "
                  f"{json.dumps(res)}", flush=True)

    # the line of kernels: times at the shape the 128x192 main path
    # launched each kernel at most often
    main_run = runs[0]
    entries = []
    for name, src, tpu in (
            ("edge_system", "goslam_tpu_torch/csrc/edge_system.cu",
             "goslam_tpu/ops/pallas_kernels.py:43"),
            ("alt_corr", "goslam_tpu_torch/csrc/alt_corr.cu",
             "goslam_tpu/ops/pallas_corr.py:70")):
        shape = main_run["shapes"][name][0][0]
        key = (128, shape[0]) if name == "edge_system" \
            else (128, shape[0], shape[1])
        res = checked[name][key]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": main_run["launches"][name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in checked[name].values()),
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            # no single PyTorch call computes either function
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
