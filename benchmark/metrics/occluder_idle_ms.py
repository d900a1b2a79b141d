"""occluder_idle_ms: the device's idle ms a traced frame while the host is
in the occluder query (``dxrt.occluder`` and its parts: the shadow batch's
sort and unsort, staging, binning, the any-hit work items' read, the walk),
from the program's spans (``program_spans``).  Read in the Whitted cell,
the one whose frame runs shadow rays."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "occluder")
