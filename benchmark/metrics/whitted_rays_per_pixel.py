"""whitted_rays_per_pixel: the rays a pixel of the traced Whitted frames
sent into the closest-hit query: the program's ``whitted.rays`` counter
(the rows entering each pass's query: each sub-pixel offset's pixels, then
each bounce's live rows) over the traced frames, over frames x W x H.  spp
is primary rays only; every bounce row, the refraction split's included,
adds to it.  A program counter; a program that does not count
``whitted.rays`` reports nothing.  ``split_rays_per_pixel`` reads its
counter with this module's two helpers."""

from contextlib import contextmanager


@contextmanager
def watch_counter(key: str):
    """The delta of the program's counter ``key`` while open, as
    ``seen["delta"]``; None where the program has no counters."""
    try:
        from directx_raytracer_tpu_torch.utils import trace
    except ImportError:
        yield None
        return
    seen = {"before": trace.COUNTS[key]}
    try:
        yield seen
    finally:
        seen["delta"] = trace.COUNTS[key] - seen["before"]


def per_pixel(ctx, name: str):
    """Metric ``name``'s watched delta over frames x W x H, None where
    nothing was counted."""
    seen, t = ctx.watched.get(name), ctx.trace
    if not seen or not seen.get("delta") or t is None or t.frames <= 0:
        return None
    return seen["delta"] / (t.frames * ctx.scene["width"] * ctx.scene["height"])


def watch(program):
    return watch_counter("whitted.rays")


def read(ctx):
    return per_pixel(ctx, "whitted_rays_per_pixel")
