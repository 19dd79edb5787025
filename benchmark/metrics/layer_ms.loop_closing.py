"""Mean ms of the program's span ``slam.loop_closing``: Backend.loop_ba
inside a frontend update (edge proposal with the neighbourhood vote, the
low-memory steps), apart from the rest of the frontend (the port's
tracer: host time, no synchronize of its own)."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    return program.mean_ms("slam.loop_closing")
