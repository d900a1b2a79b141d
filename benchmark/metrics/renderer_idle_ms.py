"""renderer_idle_ms: the device's idle ms a traced frame under no layer's
span: the frame's and its passes' own code (``dxrt.frame.*``,
``dxrt.pass``) and the caller's loop between frames, from the program's
spans (``program_spans``).  With ``query_idle_ms``, ``occluder_idle_ms``
and ``wavefront_idle_ms`` it adds up to the window's idle ms a frame."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "renderer")
