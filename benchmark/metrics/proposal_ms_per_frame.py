"""Ms per tracked frame of edge proposal: the program's ``slam.propose``
spans (the frontend's proximity scan, global BA's and loop closing's
distance matrix and native scan, and the new edges' set-up), summed over
the window and divided by the frames tracked (the port's tracer and its
``frames`` counter)."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    frames = program.counter("frames")
    d = program.durations_s("slam.propose")
    if not frames or not d:
        return None
    return 1e3 * sum(d) / frames
