"""Edges per loop-closing call: the program's counters
``loop_closing.edges / loop_closing.calls``, counted at every
Backend.loop_ba (the frontend's live edges it is seeded with and the
proposed loop edges, up to 8 x loop_window)."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    calls = program.counter("loop_closing.calls")
    if not calls:
        return None
    return program.counter("loop_closing.edges") / calls
