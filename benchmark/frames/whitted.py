"""The Whitted frame: ``Renderer.render_whitted_frame(max_depth, 1)``
(primary pass, hit record and attributes, direct lighting with the occluder
query, compaction, the bounce passes and the framebuffer commit), then
``Renderer.to_u8_device``, the image the viewer shows."""

from __future__ import annotations

from benchmark import port


class Program:
    def __init__(self, scene: dict, args: dict, device):
        self.renderer = port.renderer(scene, device)
        self.max_depth = int(args["max_depth"])

    def frame(self, pose):
        r = self.renderer
        port.set_pose(r, pose)
        img, _ = r.render_whitted_frame(self.max_depth, 1)
        return r.to_u8_device(img)
