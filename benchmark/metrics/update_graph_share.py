"""Share of the frontend's update steps whose device work ran as one
CUDA-graph replay: the program's counters ``update.replays /
update.calls``, counted at every FactorGraph.update.  A program that
does not count replays (one without the update step's CUDA graphs)
reads as nothing."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    trace = program.tracer()
    if trace is None:
        return None
    c = trace.counters()
    calls = c.get("update.calls", 0)
    if not calls or "update.replays" not in c:
        return None
    return 100.0 * c["update.replays"] / calls
