"""FrameState — the explicit history state threaded through the frame.

The reference keeps temporal state by remapping image ids after each frame
(main.cpp:416-420: depth<->prev_depth, gtao.output<->prev_frame, TAA
target<->history, SSR blurred<->history, GTAO accumulated<->history). Here
that state is an object render_frame returns and takes back; the remap is
a rebinding of tensors, no copy.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FrameState:
    """History buffers + frame counter.

      prev_depth      (H, W)       previous frame hardware depth
      prev_depth_half (H/2, W/2)   previous frame hi-Z mip 1
      taa_history     (H, W, 3)    TAA accumulation buffer (RGBA16F analog)
      gtao_accum      (H/2, W/2, 2) accumulated AO + sample count (RG8)
      gtao_prev       (H/2, W/2)   previous accumulated AO
      ssr_history     (H/2, W/2, 3) blurred SSR history
      prev_mvp        (4, 4)       previous view-projection
      frame_index     ()           int32 frame counter (noise, history
                                   clears), on the state's device as in
                                   vkr_tpu, so a captured frame
                                   (core/aot.py) advances it with no host
                                   read; a batch of views holds (V,)
    """

    prev_depth: torch.Tensor
    prev_depth_half: torch.Tensor
    taa_history: torch.Tensor
    gtao_accum: torch.Tensor
    gtao_prev: torch.Tensor
    ssr_history: torch.Tensor
    prev_mvp: torch.Tensor
    frame_index: torch.Tensor

    FIELDS = ("prev_depth", "prev_depth_half", "taa_history", "gtao_accum",
              "gtao_prev", "ssr_history", "prev_mvp", "frame_index")

    @staticmethod
    def initial(height: int, width: int, device) -> "FrameState":
        """Zero-initialized history, matching the reference's first-frame
        clears (clear_depth to 1.0 at main.cpp:306, clear_history flags)."""
        hh, hw = height // 2, width // 2
        f32 = dict(dtype=torch.float32, device=device)
        return FrameState(
            prev_depth=torch.ones((height, width), **f32),
            prev_depth_half=torch.ones((hh, hw), **f32),
            taa_history=torch.zeros((height, width, 3), **f32),
            gtao_accum=torch.zeros((hh, hw, 2), **f32),
            gtao_prev=torch.zeros((hh, hw), **f32),
            ssr_history=torch.zeros((hh, hw, 3), **f32),
            prev_mvp=torch.eye(4, **f32),
            frame_index=torch.zeros((), dtype=torch.int32, device=device),
        )

    def replace(self, **kwargs) -> "FrameState":
        return dataclasses.replace(self, **kwargs)
