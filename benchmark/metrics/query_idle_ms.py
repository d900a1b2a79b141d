"""query_idle_ms: the device's idle ms a traced frame while the host is in
the closest-hit query (``dxrt.query`` and its parts: staging, binning with
its width read, the walk), from the program's spans (``program_spans``)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "query")
