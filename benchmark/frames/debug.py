"""The debug frame: ``Renderer.render_frame(mode)`` (one primary ray a
pixel, the closest-hit query, the debug shading and the untiling), then
``Renderer.to_u8_device``, the image the viewer shows."""

from __future__ import annotations

from benchmark import port


class Program:
    def __init__(self, scene: dict, args: dict, device):
        self.renderer = port.renderer(scene, device)
        self.mode = int(args["mode"])

    def frame(self, pose):
        r = self.renderer
        port.set_pose(r, pose)
        return r.to_u8_device(r.render_frame(self.mode))
