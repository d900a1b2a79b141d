"""Renderer — the orchestration layer (the ``DXRTRenderer`` analog).

Counterpart of ``directx_raytracer_tpu/render/renderer.py``
(``describe_devices``, ``FrameStats``, ``Renderer.__init__``,
``Renderer.render_frame``); the Whitted and path-tracing frames come with
their slices.  The reference's renderer owns device setup, geometry
upload, acceleration-structure build and the per-frame dispatch; here:

* device selection      -> the ``device`` argument (``describe_devices``)
* geometry upload       -> build_device_scene (one-time SoA flatten + copy)
* BLAS/TLAS build       -> bvh.build_bvh (treelet clusters + Woop rows)
* camera/debug CBs      -> (position, rotation) snapshot + mode int
* DispatchRays          -> render_frame()

Intersection: the BVH path (binning + closest-hit kernels on a CUDA
device, their plain versions on the CPU) above ``BRUTE_FORCE_MAX_TRIS``
triangle slots, brute force below it.
"""

from __future__ import annotations

import logging
import time

import torch

from ..bvh import build_bvh, make_bvh_intersect_fn
from ..models.scene import Scene, build_device_scene
from .debug import render_debug

log = logging.getLogger("directx_raytracer_tpu_torch")

BRUTE_FORCE_MAX_TRIS = 512  # below this a dense sweep needs no BVH


def describe_devices() -> str:
    """Device enumeration report (the ``printAdapters`` analog,
    Application.cpp:13-46)."""
    if not torch.cuda.is_available():
        return "cpu: no CUDA device"
    lines = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"cuda:{i} {p.name} sm_{p.major}{p.minor} "
                     f"{p.total_memory / 2**30:.1f} GiB")
    return "\n".join(lines)


class FrameStats:
    """Per-second FPS / Mrays stat line (DXRTApp.cpp:82-90 analog)."""

    def __init__(self):
        self.frames = 0
        self.rays = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0
        self.mrays = 0.0

    def tick(self, n_rays: int) -> bool:
        self.frames += 1
        self.rays += n_rays
        dt = time.perf_counter() - self._t0
        if dt >= 1.0:
            self.fps = self.frames / dt
            self.mrays = self.rays / dt / 1e6
            self.frames = 0
            self.rays = 0
            self._t0 = time.perf_counter()
            return True
        return False


class Renderer:
    def __init__(self, scene: Scene, width: int | None = None,
                 height: int | None = None, device="cuda",
                 base_dir: str = "."):
        self.scene = scene
        # Honor the scene file's image size (the reference parses but
        # ignores it, hard-coding 1920x1080 — documented divergence).
        self.width = width or scene.settings.image_width
        self.height = height or scene.settings.image_height
        self.device = torch.device(device)
        self.dscene = build_device_scene(scene, self.device, base_dir=base_dir)

        n_tris = self.dscene.geometry.n_tris
        if n_tris > BRUTE_FORCE_MAX_TRIS:
            t0 = time.perf_counter()
            self.bvh = build_bvh(self.dscene.geometry)
            log.info("BVH: %d tris -> %d clusters in %.2fs on %s", n_tris,
                     self.bvh.clusters.aabb_min.shape[0],
                     time.perf_counter() - t0, self.device)
            self.intersect_fn = make_bvh_intersect_fn(self.bvh)
        else:
            self.bvh = None
            self.intersect_fn = None
            log.info("brute-force intersection (%d tris)", n_tris)
        self.stats = FrameStats()

    @property
    def camera(self):
        return self.scene.camera

    def render_frame(self, mode: int = 0) -> torch.Tensor:
        """One debug-shaded frame (the reference's only executed path), an
        (H, W, 3) f32 tensor on the renderer's device."""
        pos, rot = self.camera.snapshot()
        img = render_debug(self.dscene, pos, rot, mode, self.width,
                           self.height, intersect_fn=self.intersect_fn,
                           fetch_record=(mode <= 3))
        self.stats.tick(self.width * self.height)
        return img
