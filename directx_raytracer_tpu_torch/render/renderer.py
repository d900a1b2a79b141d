"""Renderer — the orchestration layer (the ``DXRTRenderer`` analog).

Counterpart of ``directx_raytracer_tpu/render/renderer.py``
(``describe_devices``, ``FrameStats``, ``Renderer.__init__``,
``Renderer.render_frame``, ``Renderer.render_whitted_frame``,
``Renderer.to_u8``, ``Renderer.to_u8_device``, ``Renderer.mode_name``).  As in the JAX package, path tracing is no
frame of the Renderer: ``viewer pathtrace`` builds a ``PathTracer`` from its
``dscene``, ``intersect_fn`` and ``occluder_factory``.
The reference's renderer owns device setup, geometry upload,
acceleration-structure build and the per-frame dispatch; here:

* device selection      -> the ``device`` argument (``describe_devices``)
* geometry upload       -> build_device_scene (one-time SoA flatten + copy)
* BLAS/TLAS build       -> bvh.build_bvh (treelet clusters + Woop rows)
* camera/debug CBs      -> (position, rotation) snapshot + mode int
* DispatchRays          -> render_frame() / render_whitted_frame()

Intersection and shadow rays: the BVH path above ``BRUTE_FORCE_MAX_TRIS``
triangle slots, brute force below it (``use_bvh`` overrides).  The BVH
path is the fused query (binning, closest-hit and any-hit kernels) for a
renderer on a CUDA device and the plain clustered walker for one on the
CPU (``use_kernels`` overrides; with ``use_kernels=True`` a CPU renderer
runs the kernels' plain versions).  The choice follows the device the
caller named, never whether a kernel built.
"""

from __future__ import annotations

import logging
import time

import torch

from ..bvh import build_bvh, make_bvh_intersect_fn, make_bvh_occluder_factory
from ..models.scene import Scene, build_device_scene
from ..ops.debug_shading import MODE_NAMES
from ..utils import checks
from ..utils.trace import span
from .debug import render_debug
from .whitted import render_whitted, render_whitted_checked

log = logging.getLogger("directx_raytracer_tpu_torch")

BRUTE_FORCE_MAX_TRIS = 512  # below this a dense sweep needs no BVH


def describe_devices() -> str:
    """Device enumeration report (the ``printAdapters`` analog,
    Application.cpp:13-46): this host's CUDA devices and, in a process
    that has joined a process group (parallel.init_distributed), the job:
    its world size, this process's rank and the backend."""
    import torch.distributed as dist

    lines = []
    if not torch.cuda.is_available():
        lines.append("cpu: no CUDA device")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"cuda:{i} {p.name} sm_{p.major}{p.minor} "
                     f"{p.total_memory / 2**30:.1f} GiB")
    if dist.is_available() and dist.is_initialized():
        lines.append(f"distributed: rank {dist.get_rank()} of "
                     f"{dist.get_world_size()} processes, backend "
                     f"{dist.get_backend()}")
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
                 base_dir: str = ".", use_bvh: bool | None = None,
                 use_kernels: bool | None = None):
        self.scene = scene
        # Honor the scene file's image size (the reference parses but
        # ignores it, hard-coding 1920x1080 — documented divergence).
        self.width = width or scene.settings.image_width
        self.height = height or scene.settings.image_height
        self.device = torch.device(device)
        self.dscene = build_device_scene(scene, self.device, base_dir=base_dir)

        n_tris = self.dscene.geometry.n_tris
        if use_bvh is None:
            use_bvh = n_tris > BRUTE_FORCE_MAX_TRIS
        if use_kernels is None:
            use_kernels = self.device.type != "cpu"
        if use_bvh:
            t0 = time.perf_counter()
            self.bvh = build_bvh(self.dscene.geometry)
            log.info("BVH: %d tris -> %d clusters in %.2fs on %s (kernels=%s)",
                     n_tris, self.bvh.clusters.aabb_min.shape[0],
                     time.perf_counter() - t0, self.device, use_kernels)
            self.intersect_fn = make_bvh_intersect_fn(
                self.bvh, use_kernels=use_kernels)
            self.occluder_factory = make_bvh_occluder_factory(
                self.bvh, use_kernels=use_kernels)
        else:
            self.bvh = None
            self.intersect_fn = None
            self.occluder_factory = None
            log.info("brute-force intersection (%d tris)", n_tris)
        self.stats = FrameStats()

    @property
    def camera(self):
        return self.scene.camera

    def render_frame(self, mode: int = 0) -> torch.Tensor:
        """One debug-shaded frame (the reference's only executed path), an
        (H, W, 3) f32 tensor on the renderer's device."""
        with span("dxrt.frame.debug"):
            pos, rot = self.camera.snapshot()
            img = render_debug(self.dscene, pos, rot, mode, self.width,
                               self.height, intersect_fn=self.intersect_fn,
                               fetch_record=(mode <= 3))
            self.stats.tick(self.width * self.height)
            return img

    def render_whitted_frame(self, max_depth: int = 5, spp: int = 1):
        """One Whitted frame (the capability surface the reference parses
        but never executes — materials, lights, shadows, specular): an
        (H, W, 3) f32 tensor on the renderer's device, and the per-pass
        alive/dropped stats."""
        with span("dxrt.frame.whitted"):
            pos, rot = self.camera.snapshot()
            fn = render_whitted_checked if checks.enabled() else render_whitted
            img, stats = fn(
                self.dscene, pos, rot, self.width, self.height,
                max_depth=max_depth, spp=spp, intersect_fn=self.intersect_fn,
                occluder_factory=self.occluder_factory)
            self.stats.tick(self.width * self.height * spp)
            return img, stats

    @staticmethod
    def to_u8(img):
        """UNORM u8 conversion to a host numpy array."""
        from ..utils.image import to_u8

        return to_u8(img)

    @staticmethod
    def to_u8_device(img: torch.Tensor) -> torch.Tensor:
        """UNORM u8 conversion on the image's device (the rounding of
        utils.image.to_u8), without a host copy (span ``dxrt.to_u8``)."""
        with span("dxrt.to_u8"):
            return (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    @staticmethod
    def mode_name(mode: int) -> str:
        return MODE_NAMES[mode]
