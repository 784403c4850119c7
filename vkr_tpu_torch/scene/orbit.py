"""The bench camera: a slow orbit inside the colonnade hall.

The same constants and formula as vkr_tpu's bench_orbit_view
(bench.py:89-114). The orbit rate must keep the eye INSIDE the hall: the
walls sit at z = +-6 and the orbit radius is ~22.1, so 0.01 rad/frame
keeps 16 frames inside (max angle 0.15 -> eye z -5.25).
"""

from __future__ import annotations

import numpy as np

from vkr_tpu_torch.mathlib.transforms import look_at

BENCH_EYE = (-18.0, 2.2, -2.0)
BENCH_CENTER = (4.0, 1.8, 0.5)
ORBIT_RATE = 0.01  # rad / frame


def bench_orbit_view(i: int) -> np.ndarray:
    """Frame i's (4, 4) view matrix."""
    eye = np.array(BENCH_EYE, np.float32)
    center = np.array(BENCH_CENTER, np.float32)
    ang = ORBIT_RATE * i
    rot = np.array(
        [[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
         [np.sin(ang), 0, np.cos(ang)]], np.float32)
    return look_at(center + rot @ (eye - center), center, (0, -1, 0))
