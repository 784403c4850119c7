"""Fly camera — the reference's conventions (scene/camera.hpp), in numpy,
as vkr_tpu/scene/camera.py has it.

Yaw/pitch Euler angles in degrees (YAW=90 looks down +z), world up
(0,-1,0) to match the reference's Vulkan y-down setup (main.cpp:293),
WASD/QE move API without the SDL plumbing.
"""

from __future__ import annotations

import numpy as np

from vkr_tpu_torch.mathlib.transforms import look_at

YAW = 90.0
PITCH = 0.0
SPEED = 15.0
SENSITIVITY = 0.25


class Camera:
    def __init__(self, position=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0),
                 yaw: float = YAW, pitch: float = PITCH):
        self.pos = np.asarray(position, np.float32)
        self.world_up = np.asarray(up, np.float32)
        self.yaw = yaw
        self.pitch = pitch
        self.speed = 1.0
        self._update_vectors()

    def _update_vectors(self):
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = (np.cos(np.radians(self.pitch)),
                  np.sin(np.radians(self.pitch)))
        f = np.array([cy * cp, sp, sy * cp], np.float32)
        self.front = f / np.linalg.norm(f)
        r = np.cross(self.front, self.world_up)
        self.right = r / np.linalg.norm(r)
        u = np.cross(self.right, self.front)
        self.up = u / np.linalg.norm(u)

    def rotate(self, dx: float, dy: float):
        """Mouse-look analog (camera.hpp:79-85)."""
        self.yaw += -dx * SENSITIVITY
        self.pitch = float(np.clip(self.pitch - dy * SENSITIVITY, -89, 89))
        self._update_vectors()

    def move(self, dt: float, forward=0.0, up=0.0, strafe=0.0):
        """camera.hpp:91-93: pos += speed*dt*(x*front + y*up + z*right)."""
        self.pos = self.pos + self.speed * dt * (
            forward * self.front + up * self.up + strafe * self.right
        )

    def view_matrix(self) -> np.ndarray:
        return look_at(self.pos, self.pos + self.front, self.up)
