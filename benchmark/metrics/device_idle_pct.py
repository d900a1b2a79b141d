"""device_idle_pct: the share of the profiled window in which no device
record runs (the window less the union of the kernel, copy and fill
intervals)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
