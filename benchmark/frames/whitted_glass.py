"""The supersampled Whitted frame: ``Renderer.render_whitted_frame(max_depth,
spp)`` (the sub-pixel offsets' rays in one wavefront: a primary pass,
direct lighting with the occluder query, the refraction split into two
branches, compaction and the bounce passes; one framebuffer), then
``Renderer.to_u8_device``,
the image the viewer's ``--whitted --depth <max_depth> --spp <spp>`` shows."""

from __future__ import annotations

from benchmark import port


class Program:
    def __init__(self, scene: dict, args: dict, device):
        self.renderer = port.renderer(scene, device)
        self.max_depth = int(args["max_depth"])
        self.spp = int(args["spp"])

    def frame(self, pose):
        r = self.renderer
        port.set_pose(r, pose)
        img, _ = r.render_whitted_frame(self.max_depth, self.spp)
        return r.to_u8_device(img)
