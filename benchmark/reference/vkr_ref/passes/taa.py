"""TAA resolve pass.

Reference: src/taa.cpp + shaders/taa/resolve.comp; vkr_tpu/passes/taa.py.
The camera jitters through the fixed 4-point sequence (main.cpp:93-108);
resolve reprojects uv + velocity, clamps the history sample to the min/max
of its 4 immediate neighbors, blends mix(history, current, 0.1), and
validates reprojection by world-space position error against a
distance-scaled epsilon. All six history fetches run in one K6 call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkr_ref.core.registry import register
from vkr_ref.mathlib.projection import reconstruct_view_vec
from vkr_ref.passes.sampling import band_slice, screen_uv_grid
from vkr_ref.raster import gather_kernel as _gather


class TAAParams(NamedTuple):
    inverse_camera: torch.Tensor
    prev_inverse_camera: torch.Tensor
    fovy: float
    aspect: float
    znear: float
    zfar: float


@register("taa_resolve")
def taa_resolve(history_color, history_depth, current_depth, velocity,
                current_color, params: TAAParams,
                use_kernel_gather: bool = True, row0: "int | None" = None,
                band_h: "int | None" = None):
    """history_color (H, W, 3), history_depth (H, W) previous frame depth,
    current_depth (H, W), velocity (H, W, 2), current_color (H, W, 3).
    Returns the resolved (H, W, 3). The six history taps are one K6 call,
    or its plain version with use_kernel_gather=False. row0/band_h (band
    mode, vkr_tpu taa.py:33): the rows [row0, row0 + band_h) from
    whole-frame inputs; K6 reads the whole history."""
    H, W = current_depth.shape
    h = H if row0 is None else band_h
    velocity, current_color, current_depth = (
        band_slice(a, row0, h) for a in (velocity, current_color,
                                         current_depth))
    uv = screen_uv_grid(h, W, current_depth.device, row0=row0 or 0,
                        full_height=H)
    delta_len = torch.linalg.vector_norm(velocity, dim=-1)
    prev_uv = uv + velocity
    in_bounds = ((prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
                 & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1))

    gather = (_gather.taa_history_gather if use_kernel_gather
              else _gather.taa_history_gather_reference)
    taps = gather(
        history_color.contiguous(), history_depth.contiguous(),
        velocity[..., 1] * H, velocity[..., 0] * W, row0=row0 or 0)
    history = taps[0:3].permute(1, 2, 0)
    c0, c1, c2, c3 = (taps[3 * k: 3 * k + 3].permute(1, 2, 0)
                      for k in range(1, 5))
    color_min = torch.minimum(torch.minimum(c0, c1), torch.minimum(c2, c3))
    color_max = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
    history = torch.minimum(torch.maximum(history, color_min), color_max)

    blended = history + (current_color - history) * 0.1

    def world(d, inv_cam, suv):
        vc = reconstruct_view_vec(suv, d, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        return vc @ inv_cam[:3, :3].T + inv_cam[:3, 3]

    w_cur = world(current_depth, params.inverse_camera, uv)
    w_prev = world(taps[15], params.prev_inverse_camera, prev_uv)
    cam = params.inverse_camera[:3, 3]
    error = torch.linalg.vector_norm(w_cur - w_prev, dim=-1)
    pixel_dist = torch.linalg.vector_norm(w_cur - cam, dim=-1)
    reprojected = in_bounds & (
        (delta_len < 0.005)
        | (error < (0.1 * pixel_dist * delta_len).clamp(0.01, 0.2))
    )
    return torch.where(reprojected[..., None], blended, current_color)
