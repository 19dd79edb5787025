"""Percent of the frames tracked that the motion filter admitted as
keyframes: the program's counters ``keyframes / frames``."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    frames = program.counter("frames")
    if not frames:
        return None
    return 100.0 * program.counter("keyframes") / frames
