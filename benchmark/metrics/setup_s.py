"""setup_s: from the process's start (read from /proc) to the first timed
frame: CUDA initialisation, loading (or in a fresh checkout building) the
kernels, the scene and its BVH built from the seed, and the warm-up
frames."""


def read(ctx):
    return ctx.window.setup_s
