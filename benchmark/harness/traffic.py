"""The one traffic generator: a camera path and a frame loop read from a
traffic file (benchmark/traffic/<mix>.json).

A mix is parameters only:
  camera          "orbit_sweep": the bench orbit of the port's
                  scene/orbit.py (eye rotated about center around the
                  y axis by an angle), the angle swept back and forth
                  between lo_rad and hi_rad in steps of rate_rad
  eye, center, up the orbit's look-at (world up (0, -1, 0) in Vulkan's
                  y-down clip space)
  jitter          the TAA jitter on (the frame index picks its offset)
  in_flight       frames dispatched before the oldest is waited for
  warmup_frames   frames rendered one at a time in set-up, after the
                  capture
  checked_pairs   pairs of consecutive window frames the reference checks

The sweep's phase comes from the seed: every seed shows the same angles,
the same number of times over a sweep period, from another start.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Traffic:
    camera: str
    eye: tuple
    center: tuple
    up: tuple
    rate_rad: float
    lo_rad: float
    hi_rad: float
    jitter: bool
    in_flight: int
    warmup_frames: int
    checked_pairs: int

    @staticmethod
    def load(path: str) -> "Traffic":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(Traffic)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"{path}: unknown traffic keys {sorted(unknown)}")
        t = Traffic(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in raw.items()})
        if t.camera != "orbit_sweep":
            raise ValueError(f"{path}: camera {t.camera!r} is not one the "
                             "generator knows (orbit_sweep)")
        if t.in_flight < 1 or t.hi_rad < t.lo_rad or t.rate_rad <= 0:
            raise ValueError(f"{path}: in_flight >= 1, hi_rad >= lo_rad and "
                             "rate_rad > 0")
        return t

    @property
    def steps(self) -> int:
        """Angles in the sweep: lo_rad, lo_rad + rate_rad, ... <= hi_rad."""
        return int(math.floor((self.hi_rad - self.lo_rad) / self.rate_rad
                              + 1e-9)) + 1

    @property
    def period(self) -> int:
        """Frames of one sweep there and back."""
        return max(1, 2 * (self.steps - 1))

    def phase(self, seed: int) -> int:
        return int(np.random.default_rng(seed).integers(self.period))

    def angle(self, seed: int, frame: int) -> float:
        """The orbit angle of frame `frame` (0 is the capture frame)."""
        k = (self.phase(seed) + frame) % self.period
        j = k if k < self.steps else self.period - k
        return self.lo_rad + self.rate_rad * j

    def view(self, seed: int, frame: int) -> np.ndarray:
        """Frame `frame`'s (4, 4) float32 view matrix."""
        return orbit_view(self.eye, self.center, self.up,
                          self.angle(seed, frame))


def look_at(eye, center, up):
    """Right-handed lookAt (glm::lookAtRH), the port's
    mathlib/transforms.py:look_at. Returns the 4x4 view matrix."""
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


def orbit_view(eye, center, up, ang: float) -> np.ndarray:
    """The port's scene/orbit.py:bench_orbit_view formula at angle ang:
    eye rotated about center around the y axis."""
    eye = np.array(eye, np.float32)
    center = np.array(center, np.float32)
    rot = np.array(
        [[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
         [np.sin(ang), 0, np.cos(ang)]], np.float32)
    return look_at(center + rot @ (eye - center), center, up)
