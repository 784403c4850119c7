"""Camera / projection matrices, GLM conventions (host-side numpy).

The reference uses glm with GLM_FORCE_DEPTH_ZERO_TO_ONE (scene/camera.hpp:5)
— right-handed look-at, Vulkan clip space with depth in [0, 1] — and a world
up of (0, -1, 0) to compensate for Vulkan's y-down NDC (main.cpp:293).
Matrices are row-major float32 numpy arrays applied to column vectors
(M @ v); the frame uploads them as tensors.
"""

from __future__ import annotations

import numpy as np


def look_at(eye, center, up):
    """Right-handed lookAt (glm::lookAtRH). Returns 4x4 view matrix."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)

    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_vk(fovy: float, aspect: float, znear: float, zfar: float):
    """glm::perspectiveRH with GLM_FORCE_DEPTH_ZERO_TO_ONE (depth in [0,1]).

    Matches the reference projection (main.cpp:294). Maps view-space z<0
    in front of the camera; NDC y is down (Vulkan).
    """
    tan_half = np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m


# Alias used throughout the passes.
perspective = perspective_vk


def inverse_rigid(m):
    """Inverse of a rigid (rotation + translation) 4x4 matrix."""
    m = np.asarray(m, np.float32)
    r = m[:3, :3]
    t = m[:3, 3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def normal_matrix(m):
    """transpose(inverse(M)) — the reference's normal transform
    (main.cpp:377)."""
    return np.linalg.inv(np.asarray(m, np.float64)).T.astype(np.float32)


# The reference's 4-point TAA jitter sequence (main.cpp:93-108):
# offsets in [0,1]^2 mapped to [-1,1] then scaled by the inverse resolution.
_TAA_OFFSETS = np.array(
    [[0.25, 0.25], [0.75, 0.75], [0.75, 0.25], [0.25, 0.75]], dtype=np.float32
)


def taa_jitter_sequence(width: int, height: int) -> np.ndarray:
    """Returns the (4, 2) NDC jitter offsets added to clip xy (scaled by w):
    gl_Position += w * jitter (gbuf/opaque_taa.vert:40)."""
    inv_res = np.array([1.0 / width, 1.0 / height], dtype=np.float32)
    return (2.0 * _TAA_OFFSETS - 1.0) * inv_res
