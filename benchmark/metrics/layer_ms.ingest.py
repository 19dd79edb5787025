"""Mean ms of the program's span ``slam.ingest``: SLAMSystem.track's host
conversion of a frame (to uint8, depth to fp16) and its copies to the
device, one span a frame (the port's tracer: host time, no synchronize
of its own)."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    return program.mean_ms("slam.ingest")
