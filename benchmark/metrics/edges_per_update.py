"""Live edges per frontend update: the program's counters
``update.edges / update.calls``, counted at every FactorGraph.update
from the host's edge mask."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    calls = program.counter("update.calls")
    if not calls:
        return None
    return program.counter("update.edges") / calls
