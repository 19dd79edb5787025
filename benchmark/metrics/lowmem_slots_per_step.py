"""Edge slots the backend's low-memory step ran its per-edge work over,
per step: the program's counters ``update_lowmem.slots /
update_lowmem.steps``, counted at every FactorGraph.update_lowmem (global
BA and loop closing; the bucket of slots that holds the live edges, at
each of the call's steps).  A program that counts no slots (one whose
low-memory step runs over fixed chunks of every slot) reads as
nothing."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    trace = program.tracer()
    if trace is None:
        return None
    c = trace.counters()
    steps = c.get("update_lowmem.steps", 0)
    if not steps or "update_lowmem.slots" not in c:
        return None
    return c["update_lowmem.slots"] / steps
