"""any_hit_ms: device time a frame of the any-hit kernel (the occluder
query's walk)."""

from benchmark.metrics import own_kernels


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = own_kernels.device_us(t, "any_hit")
    return us / 1e3 / t.frames if us > 0 else None
