"""split_rays_per_pixel: the refraction split's second branch a pixel of
the traced Whitted frames: the program's ``whitted.split`` counter (the
refractive surfaces' Fresnel reflections that each pass sends live into
its compaction, beside the transmitted rays) over the traced frames, over
frames x W x H.  A program counter; a program that does not count
``whitted.split``, or frames that met no glass, report nothing."""

from benchmark.metrics.whitted_rays_per_pixel import per_pixel, watch_counter


def watch(program):
    return watch_counter("whitted.split")


def read(ctx):
    return per_pixel(ctx, "split_rays_per_pixel")
