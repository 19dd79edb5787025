"""The port's tracer: spans and counters at its layer boundaries.

Off by default.  ``enable()`` turns it on, ``disable()`` off; what it
recorded stays until ``reset()``.

  * ``span(name)`` is a context manager.  On, it records the span's
    name, its start and end (``time.perf_counter_ns()``), the span open
    around it (its parent) and the frame it belongs to (``at_frame``,
    which ``SLAMSystem.track`` calls with its ``frame_count``), and it is
    also a ``torch.profiler.record_function`` range of the same name, so
    a profile's host timeline carries the program's names.  Off, it is
    one test of a module global and returns a shared null context:
    nothing is allocated, opened or timed.
  * ``add(counter, n)`` adds to a named integer counter, on only.  `n`
    is a host int or a device tensor; a tensor is summed on the device
    and read when the counters are read (``counters()``).
    ``launch(kernel)`` counts one launch of a hand-written kernel
    (``launch.<kernel>``), on or off: the count shows that a path went
    through the kernel.

Neither synchronizes the device, and no counter reads a device value
before ``counters()``: a span's duration is the host's time in it, a
wait for the device included.  Readers: ``records()``, ``counters()``,
``clock_offset_ns()`` (the profiler's clock minus ``perf_counter_ns``,
measured when the tracer is enabled or reset) and
``write_chrome(path)``, which writes the spans as Chrome-trace complete
events and the counters as counter events, on the ``perf_counter``
clock.

Span names begin with ``slam.``, a prefix no kernel shares:

  slam.build               SLAMSystem.__init__
    slam.build_net           DroidNet's copy to the device
    slam.build_video         the keyframe buffers' allocation and fill
    slam.build_tracker       motion filter, backend, frontend (its graph's
                             correlation volumes)
    slam.build_mapper        multiview filter and mapper
  slam.track               SLAMSystem.track, one frame
    slam.ingest              the frame's host conversion and its copies
    slam.motion_filter       MotionFilter.track
      slam.encode              the feature and context encoders
      slam.flow                one update iteration at zero flow
      slam.admit               the admit test (reads the flow's mean)
    slam.frontend            Frontend.__call__ when it works
      slam.initialize          the warm-up's 16 update steps, once a system
      slam.propose             edge proposal and the new edges' set-up
      slam.update              FactorGraph.update (also the filler's)
      slam.keyframe_test       the keyframe-distance test
      slam.loop_closing        Backend.loop_ba
        slam.propose
        slam.update_lowmem     FactorGraph.update_lowmem
    slam.global_ba           Backend.dense_ba
      slam.propose
      slam.update_lowmem
    slam.multiview_filter    MultiviewFilter.__call__
    slam.mapper              Mapper.__call__, one round
      slam.map_step            one optimizer step

Counters: ``frames``; ``keyframes`` (admitted), ``keyframes_removed``
(by the frontend); ``update.calls``, ``update.edges`` (live edges at each
``FactorGraph.update``), ``update.slots`` (the edge slots its update
operator ran over, the live edges' bucket); ``update.captures`` (each
capture of the update step into a CUDA graph), ``update.replays`` (each
update step whose device work ran as a graph replay; an eager step adds
0, so the counter is there whenever a step ran); ``update_lowmem.calls``,
``.edges``, ``.steps``, ``.slots`` (the edge slots the single-device
low-memory step ran its per-edge work over, summed over the steps:
``bucket(live edges) * steps`` a call; the sharded step counts none);
``global_ba.calls``, ``.edges``;
``loop_closing.calls``, ``.edges``; ``pcg.solves``, ``pcg.iters``;
``mapper.rounds``, ``.steps``,
``.rays``, ``.rays_depth`` (the rays whose target depth is positive,
padding left out; a device sum); ``launch.edge_system``,
``launch.alt_corr``, ``launch.schur_matvec`` (a launch captured into a
CUDA graph counts at each of the graph's replays, and not at its
capture: ``launches``, ``count_launches``).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List, NamedTuple

import torch

ON = False
_frame = 0
_records: List[list] = []          # [name, start_ns, end_ns, parent, frame]
_open: List[int] = []              # indices of the open spans, innermost last
_counters: collections.Counter = collections.Counter()
_device_counters: Dict[str, torch.Tensor] = {}   # summed on the device
_offset_ns = 0


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int        # index of the enclosing span in records(), or -1
    frame: int


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("_name", "_rf", "_rec")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        # the span's clock reads bracket the profiler range's: the range
        # lies inside the span
        rec = [self._name, time.perf_counter_ns(), 0,
               _open[-1] if _open else -1, _frame]
        _open.append(len(_records))
        _records.append(rec)
        self._rec = rec
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        return None

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _open.pop()
        self._rec[2] = time.perf_counter_ns()
        return False


def span(name: str):
    """A context manager: the span `name` while tracing is on, else a
    shared null context."""
    if not ON:
        return _NULL
    return _Span(name)


def add(counter: str, n=1):
    """Add `n` to `counter` while tracing is on: a host integer, or a
    device tensor, summed on the device without a synchronize."""
    if not ON:
        return
    if torch.is_tensor(n):
        acc = _device_counters.get(counter)
        _device_counters[counter] = n.to(torch.int64, copy=True) \
            if acc is None else acc + n
    else:
        _counters[counter] += n


def launch(kernel: str):
    """One launch of the hand-written kernel `kernel`, counted whether
    tracing is on or off."""
    _counters["launch." + kernel] += 1


def launches() -> Dict[str, int]:
    """The launch counters: ``launch.<kernel>`` -> launches."""
    return {k: n for k, n in _counters.items() if k.startswith("launch.")}


def count_launches(counts: Dict[str, int], sign: int = 1):
    """Add ``launches()``-style `counts` to the launch counters (`sign`
    -1 takes them back): a CUDA graph's launches count at each replay,
    and not at its capture, which launches nothing."""
    for k, n in counts.items():
        _counters[k] += sign * n


def at_frame(frame: int):
    """The frame the spans opened from now on belong to."""
    global _frame
    _frame = frame


def _measure_offset():
    """The profiler's host clock (the Unix clock, in ns) minus
    ``perf_counter_ns``, from the tightest of a few paired reads."""
    global _offset_ns
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    _offset_ns = best[1]


def enable():
    global ON
    _measure_offset()
    ON = True


def disable():
    global ON
    ON = False


def reset():
    """Forget every span and counter (the launch counts too)."""
    _records.clear()
    _open.clear()
    _counters.clear()
    _device_counters.clear()
    _measure_offset()


def records() -> List[Span]:
    """The spans recorded, in the order they opened; a span still open
    has end_ns 0."""
    return [Span(*r) for r in _records]


def counters() -> Dict[str, int]:
    """Every counter's value; a device counter is read here (one
    synchronize)."""
    out = dict(_counters)
    for k, t in _device_counters.items():
        out[k] = out.get(k, 0) + int(t)
    return out


def clock_offset_ns() -> int:
    """Add to a span's time to get the profiler's clock."""
    return _offset_ns


def write_chrome(path: str):
    """The spans as Chrome-trace complete events ("ph": "X", their frame
    and parent in "args") and each counter as a counter event at the end
    of the trace, in microseconds of ``perf_counter``; loads in
    chrome://tracing or Perfetto.  The counters are also under
    "counters"."""
    events, pid = [], os.getpid()
    last = 0
    for i, r in enumerate(_records):
        name, s, e, parent, frame = r
        last = max(last, e, s)
        events.append({"name": name, "ph": "X", "pid": pid, "tid": 0,
                       "ts": s / 1e3, "dur": max(e - s, 0) / 1e3,
                       "args": {"frame": frame, "parent": parent,
                                "index": i}})
    totals = counters()
    for name, n in sorted(totals.items()):
        events.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                       "ts": last / 1e3, "args": {"value": n}})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "counters": totals,
                   "clock_offset_ns": _offset_ns}, f)
