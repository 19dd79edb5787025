"""Edge slots the frontend's update operator ran over, per update step:
the program's counters ``update.slots / update.calls``, counted at every
FactorGraph.update (the bucket of slots that holds its live edges).  A
program that counts no slots (one whose update step runs over every
slot of its graph) reads as nothing."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    trace = program.tracer()
    if trace is None:
        return None
    c = trace.counters()
    calls = c.get("update.calls", 0)
    if not calls or "update.slots" not in c:
        return None
    return c["update.slots"] / calls
