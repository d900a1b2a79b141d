"""wavefront_idle_ms: the device's idle ms a traced frame while the host is
in raygen, the hit record, shading, compaction, the framebuffer commit or
the u8 conversion (``dxrt.raygen``, ``dxrt.hit_record``, ``dxrt.shade``,
``dxrt.compact``, ``dxrt.commit``, ``dxrt.to_u8``), from the program's
spans (``program_spans``)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "wavefront")
