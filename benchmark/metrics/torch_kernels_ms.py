"""torch_kernels_ms: device time a frame of every record that is not one
of the port's hand-written kernels: the torch chains of raygen, shading,
compaction and the framebuffer, and their copies and fills."""

from benchmark.metrics import own_kernels


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return sum(e - s for name, s, e in t.kernels
               if not own_kernels.is_own(name)) / 1e3 / t.frames
