"""Pinhole camera with the full interactive control API of the reference.

Counterpart of ``directx_raytracer_tpu/models/camera.py`` (``Camera``),
copied unchanged: it is host-side numpy and imports no framework.

Mirrors ``CRTCamera`` (reference: CRTCamera.{h,cpp}) semantics exactly:

* state = world position + 3x3 rotation matrix whose **columns** are
  (right, up, forward); the view direction is ``-forward`` (the raygen
  shader rotates camera-space ``(x, y, -1)``, HLSL/ray_tracing_shaders.hlsl:46-47).
* ``pan``/``tilt``/``roll`` compose axis rotations on the right
  (CRTCamera.cpp:9-43).
* ``zoom``/``move_forward`` translate along column 2, ``move_right`` along
  column 0 (CRTCamera.cpp:45-55, 89-111).
* ``rotate(yaw, pitch)`` is the FPS mouse-look path: accumulates yaw/pitch in
  radians, clamps pitch to +/-89 deg, and **rebuilds** the matrix from the
  spherical forward vector (CRTCamera.cpp:57-87) — discarding any roll.
* ``pan_around_target`` orbits the position about a target point using the
  row-vector convention ``v @ M`` (CRTCamera.cpp:113-130).

The camera is deliberately host-side, mutable, float32 numpy: it is the
interactive-input endpoint (WASD / mouse-look, DXRTApp.cpp:92-107), and only
its ``(position, rotation)`` snapshot crosses to the device each frame —
the analog of the camera constant-buffer upload (DXRTRenderer.cpp:248-270).
"""

from __future__ import annotations

import numpy as np

from ..utils import vecmath as vm


class Camera:
    def __init__(self, position=(0.0, 0.0, 0.0), rotation=None):
        self.position = np.asarray(position, dtype=np.float32).copy()
        self.rotation = (
            np.eye(3, dtype=np.float32)
            if rotation is None
            else np.asarray(rotation, dtype=np.float32).copy()
        )
        # FPS-look accumulators (radians) — CRTCamera.h yaw/pitch members.
        self.yaw = 0.0
        self.pitch = 0.0

    # -- orientation ------------------------------------------------------
    def pan(self, degrees: float) -> None:
        self.rotation = self.rotation @ vm.rot_y(degrees)

    def tilt(self, degrees: float) -> None:
        self.rotation = self.rotation @ vm.rot_x(degrees)

    def roll(self, degrees: float) -> None:
        self.rotation = self.rotation @ vm.rot_z(degrees)

    def rotate(self, delta_yaw_deg: float, delta_pitch_deg: float) -> None:
        """FPS mouse-look (CRTCamera.cpp:57-87): accumulate + clamp pitch to
        +/-89 deg, rebuild matrix columns = (right, up, forward)."""
        self.yaw += delta_yaw_deg * vm.DEG2RAD
        self.pitch += delta_pitch_deg * vm.DEG2RAD
        max_pitch = 89.0 * vm.DEG2RAD
        self.pitch = float(np.clip(self.pitch, -max_pitch, max_pitch))

        fx = np.cos(self.pitch) * np.sin(self.yaw)
        fy = np.sin(self.pitch)
        fz = np.cos(self.pitch) * np.cos(self.yaw)
        forward = vm.np_normalize(np.array([fx, fy, fz], dtype=np.float32))
        world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        right = vm.np_normalize(np.cross(world_up, forward))
        up = np.cross(forward, right)
        self.rotation = np.stack([right, up, forward], axis=1).astype(np.float32)

    # -- translation ------------------------------------------------------
    @property
    def forward(self) -> np.ndarray:
        return self.rotation[:, 2].copy()

    @property
    def right(self) -> np.ndarray:
        return self.rotation[:, 0].copy()

    @property
    def up(self) -> np.ndarray:
        return self.rotation[:, 1].copy()

    def zoom(self, amount: float) -> None:
        self.position = self.position + self.forward * np.float32(amount)

    def move_forward(self, distance: float) -> None:
        self.position = self.position + self.forward * np.float32(distance)

    def move_right(self, distance: float) -> None:
        self.position = self.position + self.right * np.float32(distance)

    def pan_around_target(self, degrees: float, target) -> None:
        """Orbit about ``target`` (CRTCamera.cpp:113-130); note the position
        rotates with the row-vector convention ``v @ M``."""
        target = np.asarray(target, dtype=np.float32)
        m = vm.rot_y(degrees)
        self.position = target + vm.row_vec_mul(self.position - target, m)
        self.rotation = self.rotation @ m

    # -- device snapshot ---------------------------------------------------
    def snapshot(self):
        """(position (3,), rotation (3,3)) f32 — the per-frame 'camera CB'."""
        return self.position.copy(), self.rotation.copy()

    def __repr__(self):
        return f"Camera(position={self.position.tolist()}, yaw={self.yaw:.4f}, pitch={self.pitch:.4f})"
