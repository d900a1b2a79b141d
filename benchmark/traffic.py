"""The camera path: the one generator every traffic mix feeds.

A traffic file's ``camera`` object sets ``step_deg`` ([low, high]).  The
orbit starts at an angle drawn from the run's seed, and each frame turns
the camera about the vertical axis through ``TARGET`` (the scene's centre)
by an angle drawn uniformly from ``step_deg`` with the seed.  A pose turns
the scene's own camera by the summed angle in world space: its position
about the target (``p @ rot_y``, the row-vector convention of the viewer's
``Camera.pan_around_target``) and its three axes with it (``rot_y.T @ R``),
so the camera keeps facing the target as a user's orbit does.  (The
viewer's ``pan_around_target`` composes the rotation as ``R @ rot_y``,
which at 90 degrees faces the camera away from the target.)

Warm-up poses are spread evenly around the orbit, so that the set-up meets
the views the window will meet.
"""

from __future__ import annotations

import numpy as np

TARGET = np.zeros(3)


def rot_y(degrees: float) -> np.ndarray:
    r = np.deg2rad(degrees)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


class CameraPath:
    def __init__(self, camera: dict, params: dict, rng: np.random.Generator):
        self.position = np.asarray(camera["position"], np.float64)
        self.rotation = np.asarray(camera["rotation"], np.float64)
        self.start = float(rng.uniform(0.0, 360.0))
        self.low, self.high = (float(x) for x in params["step_deg"])
        self.rng = rng
        self.angles = [self.start]

    def pose_at(self, degrees: float):
        """(position (3,), rotation (3, 3)) f32 after turning ``degrees``."""
        m = rot_y(degrees)
        pos = TARGET + (self.position - TARGET) @ m
        return pos.astype(np.float32), (m.T @ self.rotation).astype(np.float32)

    def angle(self, i: int) -> float:
        """The summed angle of window frame ``i``; steps are drawn in frame
        order, so frame ``i`` has the same pose whatever is asked first."""
        while len(self.angles) <= i:
            self.angles.append(self.angles[-1] + float(self.rng.uniform(self.low, self.high)))
        return self.angles[i]

    def pose(self, i: int):
        return self.pose_at(self.angle(i))

    def warmup(self, n: int):
        """``n`` poses spread evenly around the orbit."""
        return [self.pose_at(self.start + 360.0 * k / n) for k in range(n)]
