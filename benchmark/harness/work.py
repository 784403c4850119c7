"""The bytes a window-gather call needs, from its shapes alone: each input
byte read once and each output byte written once (the port's
chip_smoke.work_of for K4, K5 and K6, frozen at commit 19870451). A band
call's taps reach only its rows and a radius-wide halo of the images.

A call is (wrapper name, image shapes, offset shapes, radius), the
images float32 (H, W[, C]) and the offsets float32 (bh, W) or, for K4,
(K, bh, W).
"""

from __future__ import annotations

import math

F32 = 4
# the CUDA symbols of K5, K4 and K6 (csrc/window_gather.cu), as the
# profiler's kernel names begin
GATHER_SYMBOLS = ("window_gather_k5", "window_gather_multi_kernel",
                  "taa_history_gather_kernel")
WRAPPERS = ("window_gather_bilinear", "window_gather_bilinear_multi",
            "taa_history_gather")


def out_shape(name, images, offsets):
    """The call's output shape."""
    off = offsets[0]
    if name == "window_gather_bilinear_multi":
        return tuple(off)                       # (K, bh, W)
    if name == "taa_history_gather":
        return (16,) + tuple(off)               # (16, bh, W)
    img = images[0]
    return tuple(off) + ((img[2],) if len(img) == 3 else ())


def gather_bytes(name, images, offsets, radius=16) -> int:
    """Bytes the call needs (chip_smoke.work_of's window-gather branch)."""
    bh = offsets[0][-2]
    img_bytes = sum(math.prod(s) * F32 * min(1.0, (bh + 2 * radius + 1)
                                               / s[0]) for s in images)
    off_bytes = sum(math.prod(s) * F32 for s in offsets)
    return int(img_bytes) + off_bytes + math.prod(
        out_shape(name, images, offsets)) * F32
