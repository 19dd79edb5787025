"""What a traced run records: spans around calls into the port, host
synchronizations, the kernels' work, DroidNet's FLOPs, the profile.

Everything is installed by wrapping attributes of the port's classes and
modules from here (``Recorder.patch``) for the traced window only and
restored after it.  A span synchronizes the device at both edges, so it
times the call's own work, and is also a ``record_function`` range, so
the profile can name the host's activity during an idle gap.  Per-layer
metric readers (``benchmark/metrics``) install what they read.
"""
from __future__ import annotations

import time
import warnings
from collections import Counter, defaultdict

import torch

from . import formulas


class Recorder:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = defaultdict(list)       # name -> [seconds]
        self.counts = Counter()
        self.sync_sites = Counter()
        self.frames = 0
        self.window_s = None
        self.profile = None
        self.flops = 0
        self.flops_in = Counter()            # span name -> FLOPs inside
        self._active = []
        self._patches = []
        self._installed = set()
        self._counting = False
        self._acc = {}

    # -- patching ---------------------------------------------------------
    def patch(self, owner, attr, make):
        """owner.attr = make(original) until ``restore``."""
        orig = getattr(owner, attr)
        self._patches.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def restore(self):
        while self._patches:
            owner, attr, orig = self._patches.pop()
            setattr(owner, attr, orig)

    def once(self, key) -> bool:
        """True the first time `key` is asked for: a hook that several
        readers share is installed once."""
        if key in self._installed:
            return False
        self._installed.add(key)
        return True

    def sync(self):
        if self.cuda:
            paused, self._counting = self._counting, False
            torch.cuda.synchronize(self.device)
            self._counting = paused

    def span(self, owner, attr, name, when=None):
        """Time every call of owner.attr (for which `when(*args)` holds)
        as span `name`."""
        if not self.once(("span", name)):
            return
        rec = self

        def make(orig):
            def timed(*a, **k):
                if when is not None and not when(*a, **k):
                    return orig(*a, **k)
                rec.sync()
                t = time.perf_counter()
                rec._active.append(name)
                try:
                    with torch.profiler.record_function(name):
                        r = orig(*a, **k)
                finally:
                    rec._active.pop()
                rec.sync()
                rec.spans[name].append(time.perf_counter() - t)
                return r
            return timed
        self.patch(owner, attr, make)

    # -- host synchronizations -------------------------------------------
    def start_syncs(self):
        """Count host synchronizations (torch's sync debug mode "warn"):
        the hook only counts, by the warning's file and line."""
        if not self.cuda:
            return
        self._warn = warnings.catch_warnings(record=True)
        self._warn.__enter__()
        warnings.simplefilter("always")

        def hook(message, category, filename, lineno, file=None, line=None):
            if self._counting and "synchroniz" in str(message):
                self.counts["host_syncs"] += 1
                self.sync_sites[f"{filename}:{lineno}"] += 1

        warnings.showwarning = hook
        self._counting = True
        torch.cuda.set_sync_debug_mode("warn")

    def stop_syncs(self):
        if not self.cuda or not hasattr(self, "_warn"):
            return
        torch.cuda.set_sync_debug_mode("default")
        self._counting = False
        self._warn.__exit__(None, None, None)

    # -- accumulators on the device (no host round trip per call) ---------
    def add(self, key, value):
        if key in self._acc:
            self._acc[key] += value
        else:
            self._acc[key] = value.double().clone() if torch.is_tensor(
                value) else value

    def total(self, key):
        v = self._acc.get(key)
        return None if v is None else float(v)

    # -- the kernels' work ----------------------------------------------
    def kernel_work(self):
        """Per launch of K1 and K2: the least time the launch's work takes
        on the chip (formulas.py), summed on the device."""
        if not self.once("kernel_work"):
            return
        from goslam_tpu_torch.ops import kernels
        rec = self

        def edge_system(orig):
            def launch(poses, disps, intrinsics, target, weight, ii, jj,
                       valid, *out):
                P, ht, wd = disps.shape
                hw, E = ht * wd, ii.shape[0]
                vf = valid.double()
                src = torch.zeros(P, dtype=torch.float64,
                                  device=disps.device).index_add_(0, ii, vf)
                pose = src.index_add(0, jj, vf)
                nbytes, flop = formulas.edge_system_work(
                    (src > 0).sum(), (pose > 0).sum(), E, vf.sum(), hw)
                rec.add("edge_system.bound_s", torch.maximum(
                    nbytes / formulas.PEAKS["hbm_bytes_s"],
                    flop / formulas.PEAKS["fp32_flops_s"]))
                rec.counts["edge_system.launches"] += 1
                return orig(poses, disps, intrinsics, target, weight, ii,
                            jj, valid, *out)
            return launch

        def alt_corr(orig):
            def launch(levels, coords, ii, jj, out):
                E, h, w, _ = coords.shape
                T, dev = levels[0].shape[0], coords.device
                both = torch.zeros(T, device=dev).index_fill_(
                    0, ii.long(), 1.0).index_fill_(0, jj.long(), 1.0)
                tgt = torch.zeros(T, device=dev).index_fill_(
                    0, jj.long(), 1.0)
                per_map = [lv.shape[1] * lv.shape[2] * lv.shape[3] * 2
                           for lv in levels]
                map_bytes = both.sum().double() * per_map[0] \
                    + tgt.sum().double() * sum(per_map[1:])
                off = torch.arange(8, device=dev) - 3
                taps = torch.zeros((), dtype=torch.float64, device=dev)
                c = coords.reshape(-1, 2)
                for l, lv in enumerate(levels):
                    cl = (c / 2 ** l).clamp(-1e4, 1e4).floor().long()
                    nx = ((cl[:, :1] + off >= 0)
                          & (cl[:, :1] + off < lv.shape[2])).sum(1)
                    ny = ((cl[:, 1:] + off >= 0)
                          & (cl[:, 1:] + off < lv.shape[1])).sum(1)
                    taps = taps + (nx * ny).sum().double()
                nbytes, f16, f32 = formulas.alt_corr_work(
                    map_bytes, E, h * w, len(levels), taps)
                P = formulas.PEAKS
                rec.add("alt_corr.bound_s", torch.maximum(
                    nbytes / P["hbm_bytes_s"],
                    f16 / P["bf16_flops_s"] + f32 / P["fp32_flops_s"]))
                rec.counts["alt_corr.launches"] += 1
                return orig(levels, coords, ii, jj, out)
            return launch

        self.patch(kernels, "edge_system", edge_system)
        self.patch(kernels, "alt_corr", alt_corr)

    # -- DroidNet's FLOPs ---------------------------------------------------
    def droidnet_flops(self):
        """FLOPs of every DroidNet call, from its input shapes."""
        if not self.once("droidnet_flops"):
            return
        from goslam_tpu_torch.models import droidnet as D
        rec = self

        def count(n):
            rec.flops += n
            for name in set(rec._active):
                rec.flops_in[name] += n

        def encoder(orig):
            def fwd(mod, x, *a, **k):
                B, H, W, _ = x.shape
                count(formulas.encoder_flops(
                    B, H, W, mod.conv2.out_channels))
                return orig(mod, x, *a, **k)
            return fwd

        def update(orig):
            def fwd(mod, net, *a, **k):
                E, h, w, _ = net.shape
                count(formulas.update_flops(E, h, w))
                return orig(mod, net, *a, **k)
            return fwd

        def edge_features(orig):
            def fwd(mod, net, *a, **k):
                E, h, w, _ = net.shape
                count(formulas.edge_features_flops(E, h, w))
                return orig(mod, net, *a, **k)
            return fwd

        def frame_head(orig):
            def fwd(mod, agg, want_upmask=True):
                P, h, w, _ = agg.shape
                count(formulas.frame_head_flops(P, h, w, want_upmask))
                return orig(mod, agg, want_upmask)
            return fwd

        self.patch(D.BasicEncoder, "forward", encoder)
        self.patch(D.UpdateModule, "forward", update)
        self.patch(D.GraphAgg, "edge_features", edge_features)
        self.patch(D.GraphAgg, "frame_head", frame_head)


def summarize(prof, window_s: float) -> dict:
    """From a torch.profiler run over the window: the union of the
    device's kernel and copy intervals (busy_s), the device operations
    that took most time, the longest idle gaps named by the innermost
    record_function range (a span, or "track") the host was in, and the
    device time of each kernel by name.  Reads the profiler's raw events:
    building its per-event Python objects takes minutes at this size."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.is_user_annotation():
            # a record_function range; the profiler mirrors each onto the
            # device's timeline, which is no device work
            if e.device_type() != DeviceType.CUDA:
                host.append((s, s + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((s, s + e.duration_ns(), e.name()))
    names = {n for _, _, n in host}
    dev = sorted(d for d in dev if d[2] not in names)
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e9
    by_name = Counter()
    for s, t, n in dev:
        by_name[n] += (t - s) / 1e9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    named = []
    for g, a, b in gaps:
        mid = (a + b) / 2
        inside = [(t - s, n) for s, t, n in host if s <= mid <= t]
        named.append([min(inside)[1] if inside else "between frames",
                      g / 1e9])
    return {"busy_s": busy, "window_s": window_s,
            "kernel_s": dict(by_name),
            "device_ops": [[n[:120], s] for n, s in by_name.most_common(10)],
            "idle_gaps": named}
