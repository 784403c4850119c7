"""The asset pipeline's entry points as plain numpy, in place of the
program's C++ library: the frozen scene code calls these. Each computes
what the library's spec (scene.build_mip_pyramid_plain,
scene._resize_rgba_plain) computes."""

from __future__ import annotations

import numpy as np


def mip_downsample_rgba8(src: np.ndarray) -> np.ndarray:
    """(n, s, s, 4) u8 -> (n, s/2, s/2, 4) u8 box filter, (sum + 2) / 4."""
    n, s, _, c = src.shape
    cur = np.asarray(src, np.uint16)
    out = (cur.reshape(n, s // 2, 2, s // 2, 2, c).sum(axis=(2, 4)) + 2) // 4
    return out.astype(np.uint8)


def resize_rgba8(src: np.ndarray, h2: int, w2: int) -> np.ndarray:
    """Bilinear (H, W, 4) u8 -> (h2, w2, 4) u8 (square targets only, the
    only ones the scene code asks for)."""
    from vkr_ref.scene.scene import _resize_rgba_plain

    if h2 != w2:
        raise ValueError("resize_rgba8: square targets only")
    return _resize_rgba_plain(np.asarray(src, np.uint8), h2)


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: a*b is exact in float64, the
    sum is rounded to odd there (its error from TwoSum), and odd rounding
    to 53 bits then nearest to 24 rounds as one rounding would."""
    p = np.asarray(a).astype(np.float64) * np.asarray(b).astype(np.float64)
    c = np.asarray(c).astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)
