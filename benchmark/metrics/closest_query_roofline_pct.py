"""closest_query_roofline_pct: the least time of the frame's primary
closest-hit query over the device time a frame of ``bin_lists`` and
``closest_hit``.

The least time is the larger of two bounds, each from the scene and the
frame alone, whatever the port's BVH, clusters, tiles or visit lists:
bytes over 3.35 TB/s (every triangle's three f32 vertices and every ray's
f32 origin and direction read once, one (t, triangle id) pair of 4-byte
words written per ray) and operations over 67 TFLOP/s f32 (one 46-operation
ray-triangle test a ray, the count of ``csrc/walk.cuh``).  Peaks: NVIDIA
H100 SXM data sheet, at its full 700 W power limit (the card the benchmark
was set up on reads 700.00 W).  Only a program that leaves work out can
read over 100%.  Read in the debug cells, whose only query is the primary
one."""

from benchmark.metrics import own_kernels

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TEST_OPS = 46


def least_seconds(n_tris: int, n_rays: int) -> float:
    bytes_moved = n_tris * 3 * 3 * 4 + n_rays * 6 * 4 + n_rays * 2 * 4
    return max(bytes_moved / HBM_BYTES_PER_S, n_rays * TEST_OPS / F32_OPS_PER_S)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = own_kernels.device_us(t, "bin_lists") + own_kernels.device_us(t, "closest_hit")
    if us <= 0:
        return None
    n_tris = sum(len(m["indices"]) // 3 for m in ctx.scene["meshes"])
    n_rays = ctx.scene["width"] * ctx.scene["height"]
    return 100.0 * least_seconds(n_tris, n_rays) / (us / 1e6 / t.frames)
