#!/usr/bin/env python3
"""Run one cell of the benchmark of ``goslam_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up loads the checkpoint, renders the cell's frames on the device from
the seed and tracks the sequence's first frames (every kernel built and
loaded, every code path of the window entered once): with a throwaway
system where the traffic replays its sequence, else with the window's
own system.  The window then drives ``SLAMSystem.track`` in closed loop,
one frame per call, each call ended by a device synchronize, for
`seconds`; a replayed sequence is tracked again from its start by a
fresh system, inside the window.  After the window a sample of the window's own steps is computed
again by the plain reference (``harness/check.py``) and held to the
configuration's limits.

The last line of standard output is the result as JSON: with --trace 0
the end-to-end metrics (fps, frame_ms_p95, setup_s), with --trace 1 the
cell's per-layer metrics, read by ``metrics/<name>.py`` from spans,
counters and a torch.profiler trace of the window.  The numbers compared
and their limits end standard error and the result line.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

# the top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "goslam_tpu")
CKPT = "checkpoints/droid_synthetic.ckpt"


def say(msg: str):
    print(f"[{time.perf_counter() - T0:7.2f} s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (goslam_tpu_torch is not goslam_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def steady_host_allocator() -> bool:
    """Fixed thresholds for glibc's malloc.  By default it maps large host
    arrays (a frame's temporaries in ``SLAMSystem.track``, megabytes
    each) fresh from the kernel, or trims them off the heap's top, by a
    threshold that moves with what the process did before: the same
    conversion of a frame then took 2 ms in one process and 7 ms in the
    next, a page fault per page.  With the thresholds fixed, freed arrays
    stay in the heap and are reused.  False where there is no glibc."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return False
    m_trim_threshold, m_mmap_threshold = -1, -3
    return bool(libc.mallopt(m_mmap_threshold, 32 << 20)) \
        and bool(libc.mallopt(m_trim_threshold, 1 << 30))


def _finite(slam) -> bool:
    import torch
    n = slam.video.counter
    v = slam.video
    return bool(torch.isfinite(v.poses[:n]).all()
                & torch.isfinite(v.disps[:n]).all())


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None,
             control: bool = False) -> dict:
    """One run of a cell (``harness.cells.find``'s `spec`) on `device`.
    `overrides` (a dict merged into the configuration) is for the tests
    on the CPU.  With `control` the result also holds the control's
    numbers: the reference computed in fp8 in the program's place, on the
    same sampled steps (``control.py``; the benchmark's runs do not).
    Returns the result and the numbers compared."""
    import torch

    from harness import cells, check, traffic
    from harness.record import Recorder, summarize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    from goslam_tpu_torch.config import update_recursive
    from goslam_tpu_torch.models.convert import load_checkpoint
    from goslam_tpu_torch.system import SLAMSystem

    cfg = copy.deepcopy(spec["config"]["config"])
    if overrides:
        update_recursive(cfg, copy.deepcopy(overrides))
    limits = spec["config"]["limits"]
    ckpt = os.path.join(ROOT, cfg["tracking"]["pretrained"])
    sd = load_checkpoint(ckpt)
    seq = traffic.make(spec["traffic"], cfg, seed, device)
    say(f"set-up: {len(seq)} frames of {list(seq.images.shape[1:])} "
        f"rendered")
    out_dir = os.path.join(tempfile.gettempdir(), "goslam_bench",
                           str(os.getpid()))
    os.makedirs(out_dir, exist_ok=True)

    def system():
        return SLAMSystem(cfg, state_dict=sd, output=out_dir, device=device)

    # warm-up: the sequence's first frames, through a throwaway system
    # where the window replays the sequence, else through the window's own
    # system, which the window goes on with
    slam = system()
    feed = seq.feed()
    for ts in range(seq.warmup_frames):
        _, k = next(feed)
        slam.track(float(ts), *seq.item(k))
    ts += 1
    sync()
    say(f"warm-up: {seq.warmup_frames} frames, {slam.video.counter} "
        f"keyframes, mapper steps "
        f"{slam.mapper.global_step if slam.mapper is not None else '-'}")
    if seq.replay:
        slam = None
        feed = seq.feed()
    gc.collect()
    gc.freeze()     # set-up's objects stay out of the window's collections
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kf_start = 0 if slam is None else slam.video.counter

    capture = check.Capture(seed)
    capture.install()
    rec = None
    readers = []
    if trace:
        rec = Recorder(device)
        for m in spec["per_layer"]:
            r = cells.reader(m["name"])
            if hasattr(r, "install"):
                r.install(rec)
            readers.append((m, r))
        rec.start_syncs()
    prof = None
    if trace and cuda:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()

    lat, failed, systems, frames_of_system = [], 0, 0, 0
    t_begin = time.perf_counter()
    setup_s = t_begin - T0
    for new, k in feed:
        if new:
            if slam is not None and not _finite(slam):
                failed += frames_of_system
            slam = None      # freed before the next system is built
            slam, ts, frames_of_system = system(), 0, 0
            systems += 1
        t = time.perf_counter()
        with torch.profiler.record_function("track"):
            slam.track(float(ts), *seq.item(k))
        sync()
        lat.append(time.perf_counter() - t)
        ts += 1
        frames_of_system += 1
        if time.perf_counter() - t_begin >= seconds:
            break
    t_end = time.perf_counter()
    window_s = t_end - t_begin
    gc.unfreeze()
    attempted = len(lat)
    q = statistics.quantiles(lat, n=100) if len(lat) > 1 else lat * 99
    quarters = [statistics.median(lat[i * attempted // 4:
                                     (i + 1) * attempted // 4] or lat)
                 for i in range(4)]
    say(f"window: {attempted} frames in {window_s:.3f} s, {systems} new "
        f"systems, the last with {slam.video.counter} keyframes (the "
        f"window began with {kf_start}); frame ms p50 {q[49] * 1e3:.1f} "
        f"p95 {q[94] * 1e3:.1f} max {max(lat) * 1e3:.1f}; p50 by quarter "
        + " ".join(f"{x * 1e3:.1f}" for x in quarters))
    top = sorted(lat)[-max(1, attempted // 10):]
    say("the slowest tenth of the frames, ms: "
        + " ".join(f"{x * 1e3:.0f}" for x in top))

    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        say(f"profiler stopped in {time.perf_counter() - t:.1f} s")
    if rec is not None:
        rec.stop_syncs()
        rec.restore()
    capture.remove()
    if not _finite(slam):
        failed += frames_of_system
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    del slam
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = {"attempted": attempted, "failed": failed}
    if trace:
        rec.frames, rec.window_s = attempted, window_s
        if prof is not None:
            t = time.perf_counter()
            rec.profile = summarize(prof, window_s)
            say(f"profile read in {time.perf_counter() - t:.1f} s")
            del prof
        metrics = {}
        for m, r in readers:
            v = r.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if rec.sync_sites:
            say("host syncs by site: " + json.dumps(
                dict(rec.sync_sites.most_common(12))))
        if rec.profile is not None:
            result["breakdown"] = {k: rec.profile[k]
                                   for k in ("device_ops", "idle_gaps")}
            result["busy_s"] = rec.profile["busy_s"]
        result["window_s"] = window_s
    else:
        values = {"fps": attempted / window_s,
                  "frame_ms_p95": q[94] * 1e3, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"]}

    # the check: the sampled steps again, by the plain reference
    t = time.perf_counter()
    from reference.net import Net, load_params
    net = Net(load_params(ckpt, device), "fp32")
    cmp = check.compare(capture, net)
    for kind, c in cmp.items():
        say(f"check {kind}: " + json.dumps(c["per"]))
    # every step the window drives, of those the configuration runs, has
    # a number: a window whose sample lacks one (a step skipped) is not
    # correct; a step the window drove beyond those is compared too
    due = {k for k in limits if check.NUMBERS[k][0] in seq.steps
           and (k != "map_step" or not cfg.get("only_tracking"))}
    numbers = {k: {"value": cmp[k]["worst"] if k in cmp else None,
                   "limit": lim} for k, lim in limits.items()
               if k in due or k in cmp}
    if control:
        ctl = check.compare(capture, net, against=Net(net.p, "fp8"))
        for kind, c in ctl.items():
            say(f"control {kind}: " + json.dumps(c["per"]))
        result["control"] = {k: c["worst"] for k, c in ctl.items()}
    ok = all(n["value"] is not None and n["value"] <= n["limit"]
             for n in numbers.values())
    say(f"check computed in {time.perf_counter() - t:.1f} s")
    result["correct"] = ok and failed == 0 and attempted > 0
    result["numbers"] = numbers
    result["memory_peak_bytes"] = memory_peak
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cells
    spec = cells.find(cells.load_benchmark(), args.workload)
    chips = spec["cell"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"no result: the cell needs {chips} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    say(f"host allocator thresholds fixed: {steady_host_allocator()}")
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace))

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["check"] = res["numbers"]
    for name, n in res["numbers"].items():
        print(f"check {name}: {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        say(f"no result: forbidden modules loaded: {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
