"""The device's idle time in the traced window, split by the layer of the
program's own spans: the helper of ``query_idle_ms``, ``occluder_idle_ms``,
``wavefront_idle_ms`` and ``renderer_idle_ms`` (no metric of its own).

The port names its steps by spans ``dxrt.<layer>[.<part>]``
(``directx_raytracer_tpu_torch/utils/trace.py``), plain host ops in the
profiler's trace, nested on the thread that runs the frame.  The idle
time, the window less the union of the device records, is cut at the
spans' bounds, and each piece goes to the innermost span over it, rolled
up to the span's layer (``LAYERS``); a piece under no span (a frame's and
its passes' own Python, the caller's loop between frames) goes to the
renderer.  So the four layers add up to the window's idle time.

The trace keeps the window's length, not its start: the start is taken
as its first host op or device record, whichever comes first, so the few
microseconds of the harness's code before it go uncounted and as many
past the window's end count as idle under no span.  A trace with no
``dxrt.`` span (a program without them) or no device record gives None.
"""

LAYERS = {"frame": "renderer", "pass": "renderer",
          "query": "query", "occluder": "occluder",
          "raygen": "wavefront", "hit_record": "wavefront", "shade": "wavefront",
          "compact": "wavefront", "commit": "wavefront", "to_u8": "wavefront"}
SPLIT = ("renderer", "query", "occluder", "wavefront")


def layer_of(name: str):
    """The layer of a ``dxrt.<layer>[.<part>]`` span, None for any other
    name."""
    parts = name.split(".")
    return LAYERS.get(parts[1]) if len(parts) > 1 and parts[0] == "dxrt" else None


def innermost(spans):
    """Disjoint (start, end, layer) pieces of properly nested (start, end,
    layer) spans, each piece the innermost span's, in order."""
    out, stack, cursor = [], [], 0.0
    for s, e, layer in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if cursor < end:
                out.append((cursor, end, top))
                cursor = end
        if stack and cursor < s:
            out.append((cursor, s, stack[-1][1]))
        cursor = s
        stack.append((min(e, stack[-1][0]) if stack else e, layer))
    while stack:
        end, top = stack.pop()
        if cursor < end:
            out.append((cursor, end, top))
            cursor = end
    return out


def idle_gaps(trace):
    """The window's idle (start, end) intervals, in order."""
    starts = [h[0] for h in trace.host[:1]] + [s for _, s, _ in trace.kernels]
    w0 = min(starts)
    w1 = w0 + trace.window_us
    gaps, end = [], w0
    for s, e in sorted((s, e) for _, s, e in trace.kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def idle_split_us(trace):
    """{layer: idle us in the window}, or None."""
    spans = [(s, e, layer_of(name)) for s, e, name in trace.host]
    spans = [x for x in spans if x[2] is not None]
    if not (spans and trace.kernels):
        return None
    split = dict.fromkeys(SPLIT, 0.0)
    pieces = innermost(spans)
    i = 0
    for g0, g1 in idle_gaps(trace):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, layer = pieces[j]
            cut = min(e, g1) - max(s, g0)
            split[layer] += cut
            covered += cut
            j += 1
        split["renderer"] += (g1 - g0) - covered
    return split


def idle_ms(ctx, layer: str):
    """The idle ms a traced frame of ``layer``, or None."""
    t = ctx.trace
    if t is None or t.frames <= 0:
        return None
    split = idle_split_us(t)
    return None if split is None else split[layer] / 1e3 / t.frames
