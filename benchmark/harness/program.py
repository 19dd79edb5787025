"""The program's own tracer (``goslam_tpu_torch/utils/trace.py``): the
spans and counters that the port records at its layer boundaries, read by
the per-layer metrics of ``source`` ``program_span`` and
``program_counter`` that name it.

``install`` turns the tracer on for the traced window only: it clears
the tracer and patches its switch (``Recorder.patch``), so that
``Recorder.restore`` turns it off after the window and what it recorded
stays for the readers.  A span is host time (the tracer never
synchronizes the device), and each is also a ``record_function`` range,
so the profile names idle gaps after the program's spans.  A program
without the tracer reads as nothing: every reader returns None."""
from __future__ import annotations


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from goslam_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def install(rec):
    trace = tracer()
    if trace is None or not rec.once("program_trace"):
        return
    trace.reset()
    rec.patch(trace, "ON", lambda was: True)


def durations_s(name: str) -> list:
    """Seconds of every recorded span called `name`."""
    trace = tracer()
    if trace is None:
        return []
    return [(s.end_ns - s.start_ns) / 1e9 for s in trace.records()
            if s.name == name and s.end_ns]


def mean_ms(name: str):
    d = durations_s(name)
    return 1e3 * sum(d) / len(d) if d else None


def counter(name: str):
    """The counter's value, 0 where it never counted; None without a
    tracer."""
    trace = tracer()
    if trace is None:
        return None
    return trace.counters().get(name, 0)
