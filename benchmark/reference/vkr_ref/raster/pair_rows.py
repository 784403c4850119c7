"""Per-pair row builder for the G-buffer kernel (K1).

One 64-float row per (tile, triangle) pair, built with a single gather.
The layout is vkr_tpu's (raster/pair_rows.py), so the two packages' pair
buffers can be fed to each other's kernels:
  [0:3]   edge a coefficients     (raster)
  [3:6]   edge b coefficients
  [6:9]   edge c constants (fill-rule biased)
  [9:12]  depth plane za zb zc
  [12]    triangle id (f32-exact)
  [13:16] pad
  [16:19] perspective denominator plane (sum e_i / w_i)  (resolve)
  [19:46] 9 attribute/w planes x (p, q, r): uv(2), normal(3), prev clip(4)
  [46]    material id
  [47:64] pad
vkr_tpu views the buffer as (n_rows, 128) and pads its tail for Mosaic's
DMA; the port keeps (n_pairs, 64) with no padding.
"""

from __future__ import annotations

import torch

from vkr_ref.core.constants import constant
from vkr_ref.raster.setup import _sum3

ROW_WIDTH = 64
# a dead pair's row: c = -1 edges (never cover), triangle and material -1
_DEAD_FIELDS = (6, 7, 8, 12, 46)
RESOLVE_BASE = 16
N_CHANNELS = 9


def corner_attributes_pre_t(attr_t, weights, n_src: int):
    """Clipped-corner attributes on component-major inputs.

    attr_t: (K, 3T) static per-corner attribute table (corner-major
    columns, built at scene upload); weights: [c][m] lists of (2T,) from
    setup.clip_near_corners_t. Returns cattrs [c][k] lists of (2T,)."""
    K = attr_t.shape[0]
    T = n_src
    att2 = [[torch.cat([attr_t[k, m * T:(m + 1) * T]] * 2)
             for k in range(K)] for m in range(3)]
    return [[_sum3(weights[c][0] * att2[0][k],
                   weights[c][1] * att2[1][k],
                   weights[c][2] * att2[2][k])
             for k in range(K)] for c in range(3)]


def build_tri_rows_t(setup_t, cattrs=None, tri_mat=None):
    """(TC, 64) rows, one per clipped triangle.

    setup_t: setup.TriangleSetupT; cattrs: [c][k] lists of (TC,);
    tri_mat: (TC,) int32. Without cattrs the rows carry the raster fields
    only: resolve fields 0 and material -1 (visibility-only raster, K7)."""
    a, b, c = setup_t.a, setup_t.b, setup_t.c
    iw = setup_t.inv_w
    tc = a[0].shape[0]
    ids = torch.arange(tc, dtype=torch.float32, device=a[0].device)
    zero = torch.zeros_like(ids)
    cols = list(a) + list(b) + list(c) + list(setup_t.zplane)
    cols += [ids, zero, zero, zero]
    if cattrs is None:
        cols += [zero] * (RESOLVE_BASE + 3 + 3 * N_CHANNELS - len(cols))
        cols.append(torch.full_like(ids, -1.0))
        cols += [zero] * (ROW_WIDTH - len(cols))
        return torch.stack(cols, dim=-1)

    denom = [
        _sum3(a[0] * iw[0], a[1] * iw[1], a[2] * iw[2]),
        _sum3(b[0] * iw[0], b[1] * iw[1], b[2] * iw[2]),
        _sum3(c[0] * iw[0], c[1] * iw[1], c[2] * iw[2]),
    ]
    aw = [[cattrs[i][k] * iw[i] for k in range(N_CHANNELS)]
          for i in range(3)]
    cols += denom
    for k in range(N_CHANNELS):  # interleaved [p_k, q_k, r_k]
        cols.append(_sum3(a[0] * aw[0][k], a[1] * aw[1][k],
                          a[2] * aw[2][k]))
        cols.append(_sum3(b[0] * aw[0][k], b[1] * aw[1][k],
                          b[2] * aw[2][k]))
        cols.append(_sum3(c[0] * aw[0][k], c[1] * aw[1][k],
                          c[2] * aw[2][k]))
    cols.append(tri_mat.to(torch.float32))
    cols += [zero] * (ROW_WIDTH - len(cols))
    return torch.stack(cols, dim=-1)


def expand_pair_rows(tri_rows, pair_tri_sorted):
    """One gather: (TC, 64) x (CAP,) -> (CAP, 64) pair rows.

    Dead pairs (id -1) get c = -1 edges (never cover) and id -1."""
    live = (pair_tri_sorted >= 0)[:, None]
    rows = tri_rows[pair_tri_sorted.clamp(min=0).long()]
    dead = constant([-1.0 if k in _DEAD_FIELDS else 0.0
                     for k in range(ROW_WIDTH)], rows.device)
    return torch.where(live, rows, dead)
