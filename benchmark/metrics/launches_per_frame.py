"""launches_per_frame: device records in the profiled window (kernels,
copies and fills: each one the host enqueued) over its frames."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.frames
