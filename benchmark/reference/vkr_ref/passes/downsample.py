"""G-buffer downsample / hi-Z pyramid pass.

Same algorithm as the reference's DownsamplePass (downsample_pass.cpp:60-135
+ advanced_ssr/downsample_gbuffer.frag + depth_downsample/shader.frag) and
vkr_tpu/passes/downsample.py:
  * mip 1 of depth = min of each 2x2 quad; half-res normal/velocity take
    the value of the min-depth texel of the quad;
  * depth mips 2..N each min-downsample the previous mip.
Min/select only, so the port equals vkr_tpu bit for bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from vkr_ref.core.registry import register


class HiZPyramid(NamedTuple):
    mips: Tuple[torch.Tensor, ...]  # depth mips 1..N (half-res down to 1)
    normal_half: torch.Tensor       # (H/2, W/2, 2) oct normals
    velocity_half: torch.Tensor     # (H/2, W/2, 2)


def _quads(img):
    """(H, W[, C]) -> (H/2, W/2, 4[, C]) in the order d0=(0,0), d1=x+1,
    d2=y+1, d3=(1,1)."""
    h, w = img.shape[:2]
    q = img.reshape(h // 2, 2, w // 2, 2, *img.shape[2:])
    return torch.stack([q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0],
                        q[:, 1, :, 1]], dim=2)


@register("downsample_gbuffer")
def downsample_gbuffer(depth, normal, velocity):
    """Full-res -> half-res (depth min + argmin-selected normal/velocity).

    downsample_gbuffer.frag's if/else chain checks d1, d2, d3 and falls
    back to d0, so on ties the priority order is d1 > d2 > d3 > d0."""
    dq = _quads(depth)
    min_depth = dq.amin(dim=2)
    pick = torch.full_like(min_depth, 0, dtype=torch.long)
    for q in (3, 2, 1):  # lowest priority first; higher ones overwrite
        pick = torch.where(dq[..., q] == min_depth, q, pick)
    idx = pick[..., None, None].expand(-1, -1, 1, 2)
    normal_half = torch.gather(_quads(normal), 2, idx)[:, :, 0]
    velocity_half = torch.gather(_quads(velocity), 2, idx)[:, :, 0]
    return min_depth, normal_half, velocity_half


@register("depth_mips")
@register("downsample_depth")  # manifest name (config.json: depth_downsample/*)
def downsample_depth_chain(depth_half) -> List[torch.Tensor]:
    """Mips 2..N by 2x2 min (depth_downsample/shader.frag), down to 1x1-ish.
    Odd extents truncate (keeps the min conservative)."""
    mips = []
    cur = depth_half
    while min(cur.shape) > 1:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        cur = _quads(cur[: h2 * 2, : w2 * 2]).amin(dim=2)
        mips.append(cur)
    return mips


@register("downsample_hiz")
def build_hiz(depth, normal, velocity) -> HiZPyramid:
    """The full DownsampleGbuffer + DownsampleDepth chain
    (downsample_pass.cpp run())."""
    d1, n_half, v_half = downsample_gbuffer(depth, normal, velocity)
    return HiZPyramid(mips=tuple([d1] + downsample_depth_chain(d1)),
                      normal_half=n_half, velocity_half=v_half)
