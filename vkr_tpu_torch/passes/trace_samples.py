"""Texture-fetch heatmap profiler.

Reference: src/trace_samples.{hpp,cpp} + include/trace_samples.glsl;
vkr_tpu/passes/trace_samples.py. A compile-time debug mode where every
texture fetch whose source pixel falls in a uv window does an
imageAtomicAdd into an R32_UINT heatmap (TRACE_SAMPLE_UV,
trace_samples.glsl:35-39), visualising texture bandwidth.

Here the analog is explicit: a pass in debug mode reports its (source uv,
fetched uv) pairs to a SamplesMarker, which scatter-adds fetch counts into
an int32 heatmap. Cleared per frame (main.cpp:343).
"""

from __future__ import annotations

from typing import Tuple

import torch

CUDA = torch.device("cuda")

# Default trace window (gtao/main.comp:29-32 constants).
DEFAULT_WINDOW = (0.5 - 1e-6, 0.5 - 1e-6, 0.5 + 8.0 / 1920.0,
                  0.5 + 4.0 / 1920.0)


class SamplesMarker:
    """Accumulates fetch-count heatmaps (SamplesMarker::init/clear analog),
    on `device` (the card unless the caller asks for another)."""

    def __init__(self, height: int, width: int,
                 window: Tuple[float, float, float, float] = DEFAULT_WINDOW,
                 device=CUDA):
        self.height = height
        self.width = width
        self.window = window
        self.heatmap = torch.zeros((height, width), dtype=torch.int32,
                                   device=device)

    def clear(self):
        """Per-frame clear (main.cpp:343)."""
        self.heatmap = torch.zeros_like(self.heatmap)

    def _index(self, coord, size):
        """int(coord * size) clipped to [0, size): float32 product,
        truncated toward zero after a saturating clamp (XLA's float-to-int
        cast saturates, PyTorch's does not)."""
        i = (coord * size).clamp(-1.0, 16777216.0).to(torch.int32)
        return i.clamp(0, size - 1).long()

    def trace(self, src_uv, fetch_uv):
        """TRACE_SAMPLE_UV(start, tc): for source pixels inside the window,
        count the fetch at tc into the heatmap.

        src_uv / fetch_uv: (..., 2) tensors of matching shape."""
        x0, y0, x1, y1 = self.window
        in_window = ((src_uv[..., 0] >= x0) & (src_uv[..., 0] <= x1)
                     & (src_uv[..., 1] >= y0) & (src_uv[..., 1] <= y1))
        xi = self._index(fetch_uv[..., 0], self.width)
        yi = self._index(fetch_uv[..., 1], self.height)
        # the indices are clipped, so nothing drops (vkr_tpu's mode="drop")
        self.heatmap = self.heatmap.index_put(
            (yi.reshape(-1), xi.reshape(-1)),
            in_window.reshape(-1).to(torch.int32), accumulate=True)
        return self.heatmap

    def to_image(self):
        """Normalised heatmap for the channel-select viewer."""
        h = self.heatmap.float()
        return h / h.max().clamp(min=1.0)
