"""host_syncs_per_frame: the points at which the traced frames' host thread
waited for the card, over the frames: the program's ``sync.*`` counters
(``directx_raytracer_tpu_torch/utils/trace.py``: each device-to-host read
and each blocking copy of a host value to the device).  A program counter;
a program without the counters reports nothing."""

from contextlib import contextmanager


@contextmanager
def watch(program):
    try:
        from directx_raytracer_tpu_torch.utils import trace
    except ImportError:
        yield None
        return
    seen = {"before": trace.syncs()}
    try:
        yield seen
    finally:
        seen["syncs"] = trace.syncs() - seen["before"]


def read(ctx):
    seen = ctx.watched.get("host_syncs_per_frame")
    t = ctx.trace
    if not seen or "syncs" not in seen or t is None or t.frames <= 0:
        return None
    return seen["syncs"] / t.frames
