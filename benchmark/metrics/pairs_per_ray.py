"""pairs_per_ray: the (ray, triangle) tests the closest-hit query
schedules for each ray, over the profiled frames: the clusters the binning
kernel lists, over the tiles, times the slots of a cluster (the arithmetic
of the port's ``tools/bench.py``).  A program counter: it reads the visit
lists of the queries the timed frames themselves ran (``port.closest_queries``).
Read in the debug cells, whose frame runs one query, the primary one."""

from benchmark import port


def watch(program):
    return port.closest_queries()


def read(ctx):
    seen = ctx.watched.get("pairs_per_ray")
    if not seen:
        return None
    pairs = sum(int(counts.sum()) * k for counts, k in seen)
    tiles = sum(int(counts.shape[0]) for counts, _ in seen)
    return pairs / tiles
