"""Percent of the mapper's rays that carry a target depth: the program's
counters ``mapper.rays_depth / mapper.rays``, counted at every map step
(padding rays left out of both).  The mapper's depth is the tracker's
own filtered disparity, so in mono this is the share of rays the
multiview filter and the tracked depth feed.  A program that does not
count rays with depth reads as nothing."""

from harness import program


def install(rec):
    program.install(rec)


def read(rec):
    trace = program.tracer()
    if trace is None:
        return None
    c = trace.counters()
    rays = c.get("mapper.rays", 0)
    if not rays or "mapper.rays_depth" not in c:
        return None
    return 100.0 * c["mapper.rays_depth"] / rays
