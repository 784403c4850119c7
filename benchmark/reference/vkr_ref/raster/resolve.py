"""Deferred attribute resolve — the second half of the visibility-buffer
rasterizer, for the oracle raster (raster/kernel.rasterize_reference).

The oracle only records which triangle won each pixel. This pass
recomputes perspective-correct barycentrics per pixel from the winner's
edge equations and interpolates vertex attributes (the work the
reference's fragment shader gets from the hardware interpolators,
gbuf/opaque_taa.frag). K1 resolves its winners itself, from the pair rows'
resolve planes; vkr_tpu/raster/resolve.py is the counterpart of this
module. Every 3-term reduction is the left-associated sum of rounded
products (setup._sum3).
"""

from __future__ import annotations

from typing import Dict

import torch

from vkr_ref.raster.pair_rows import corner_attributes_pre_t
from vkr_ref.raster.setup import _sum3


def corner_attributes(vertex_attr, indices, weights, src):
    """Vertex attributes (V, K) -> per-clipped-triangle corner values
    (TC, 3, K), applying the near-clip interpolation weights (TC, 3, 3) of
    setup.clip_near_triangles."""
    tri_attr = vertex_attr[indices[src]]  # (TC, 3 source corners, K)
    w = weights[..., None]                # (TC, 3 corners, 3 sources, 1)
    return _sum3(w[:, :, 0] * tri_attr[:, None, 0],
                 w[:, :, 1] * tri_attr[:, None, 1],
                 w[:, :, 2] * tri_attr[:, None, 2])


def corner_attributes_pre(corner_attr, weights):
    """corner_attributes for pre-gathered corner values, row-major:
    corner_attr (T, 3, K) at each source triangle's own corners, weights
    (2T, 3, 3) from clip_near_corners, which emits two clipped triangles
    per source triangle in source order. Returns (2T, 3, K), through the
    frame's component-major pair_rows.corner_attributes_pre_t."""
    t, _, k = corner_attr.shape
    attr_t = corner_attr.permute(2, 1, 0).reshape(k, 3 * t)
    w = [[weights[:, c, m] for m in range(3)] for c in range(3)]
    cattrs = corner_attributes_pre_t(attr_t, w, t)
    return torch.stack([torch.stack(cattrs[c], -1) for c in range(3)], 1)


def pixel_barycentrics(tid, setup, width: int, height: int,
                       row_offset: int = 0):
    """Perspective-correct barycentrics of each pixel's winning triangle.

    tid: (H, W) int visibility buffer (-1 = background); setup: the
    row-major setup.TriangleSetup. row_offset: the band's first row in the
    full frame: the edge planes are full-frame, so a band's pixels are
    evaluated at their global rows (vkr_tpu resolve.py:44-59). Returns (bary (H, W, 3) f32,
    mask (H, W) bool)."""
    t = tid.clamp(min=0).long()
    mask = tid >= 0
    dev = setup.a.device
    px = (torch.arange(width, dtype=torch.float32, device=dev)
          + 0.5)[None, :, None]
    py = (torch.arange(row_offset, row_offset + height, dtype=torch.float32,
                       device=dev) + 0.5)[:, None, None]
    e = setup.a[t] * px + setup.b[t] * py + setup.c[t]  # (H, W, 3)
    e = e.clamp(min=0.0)  # guard the fill-rule bias at edges
    sb = e / _sum3(e[..., 0], e[..., 1], e[..., 2]).clamp(min=1e-20)[..., None]
    q = sb * setup.inv_w[t]
    bary = q / _sum3(q[..., 0], q[..., 1], q[..., 2]).clamp(min=1e-20)[
        ..., None]
    return bary, mask


def interpolate(corner_attr, tid, bary):
    """corner_attr (TC, 3, K); tid (H, W); bary (H, W, 3) -> (H, W, K)."""
    vals = corner_attr[tid.clamp(min=0).long()]  # (H, W, 3, K)
    b = bary[..., None]
    return _sum3(b[..., 0, :] * vals[..., 0, :], b[..., 1, :] * vals[..., 1, :],
                 b[..., 2, :] * vals[..., 2, :])


def interpolate_many(corner_attrs: Dict[str, torch.Tensor], tid, bary
                     ) -> Dict[str, torch.Tensor]:
    """All attribute interpolations behind one per-pixel gather, by
    concatenating on the trailing axis."""
    names = list(corner_attrs)
    sizes = [corner_attrs[n].shape[-1] for n in names]
    out = interpolate(torch.cat([corner_attrs[n] for n in names], -1), tid,
                      bary)
    return dict(zip(names, torch.split(out, sizes, dim=-1)))
