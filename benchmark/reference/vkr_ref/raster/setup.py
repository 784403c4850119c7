"""Rasterizer front end: vertex and corner transforms, near clip, triangle
setup, tile binning.

Replaces the Vulkan fixed-function vertex/raster stages driven by the
reference's G-buffer pass (scene_renderer.cpp:140-215 + gbuf/opaque_taa.vert).
The arithmetic is the port of vkr_tpu's SoA twins (raster/setup.py:279-591):
every value is a dense (T,) component tensor, and the ops, operand pairing
and reduction association are transcribed from vkr_tpu so the per-tile pair
lists come out identical. The indexed front end gathers its corners into
the same tables (corner_table), so it equals the corner path bit for bit
(vkr_tpu states the same of its two, gbuffer.py:266-270). The row-major
entry points of vkr_tpu's generic front end that the oracle raster needs
(transform_vertices, clip_near_triangles, triangle_setup;
setup.py:41-276) take (T, 3, ...) arrays and run the same arithmetic
through the twins.

Conventions (matching the reference):
  * clip space: Vulkan, depth in [0,1], y-down NDC; clip = VP @ model @ pos
  * jitter: added to NDC xy (opaque_taa.vert:40)
  * screen: pixel centers at (x+0.5, y+0.5)
  * fill rule: top-left (Vulkan), two-sided (cull NONE, pipelines.hpp:113)
  * depth test: LESS_OR_EQUAL against cleared 1.0 (scene_renderer.cpp:186)

Corner tables are (k, 3T) with corner-major columns [c*T, (c+1)*T).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch

_FILL_EPS = 1.0 / 4096.0  # sub-pixel bias excluding non-top-left edges

# The captured frame's bin-pair capacity (core/aot.py): the pairs the
# capture frame binned, times PAIR_HEADROOM, and at least PAIR_FLOOR.
# 2.0 covers the bench orbit's frame-to-frame change of the pair count
# with room to spare; a frame beyond it counts its dropped pairs as
# overflow, which the captured frame reports.
PAIR_HEADROOM = 2.0
PAIR_FLOOR = 4096


class TriangleSetupT(NamedTuple):
    """Per-triangle raster data in component-major layout, orientation-
    normalized (interior => e >= 0). Edge i is opposite corner i;
    e_i(x, y) = a_i x + b_i y + c_i. Depth is the screen-linear NDC z plane
    d(x, y) = za x + zb y + zc."""

    a: list          # [3] of (T,) edge x-coefficients
    b: list          # [3] of (T,) edge y-coefficients
    c: list          # [3] of (T,) edge constants (fill-rule bias applied)
    zplane: list     # [3] of (T,)  [za, zb, zc]
    inv_area: torch.Tensor  # (T,)
    inv_w: list      # [3] of (T,) 1 / clip w per corner
    valid: torch.Tensor     # (T,) bool — survives face/frustum rejection
    bbox: list       # [4] of (T,) int32 [x0, y0, x1, y1] inclusive pixels


class TriangleSetup(NamedTuple):
    """TriangleSetupT in row-major layout (vkr_tpu's generic front end and
    its oracle raster): one row per triangle, one column per edge or
    corner."""

    a: torch.Tensor         # (T, 3)
    b: torch.Tensor         # (T, 3)
    c: torch.Tensor         # (T, 3)
    zplane: torch.Tensor    # (T, 3) [za, zb, zc]
    inv_area: torch.Tensor  # (T,)
    inv_w: torch.Tensor     # (T, 3)
    valid: torch.Tensor     # (T,) bool
    bbox: torch.Tensor      # (T, 4) int32 [x0, y0, x1, y1]


def _rowmajor(st: TriangleSetupT) -> TriangleSetup:
    return TriangleSetup(
        a=torch.stack(st.a, -1), b=torch.stack(st.b, -1),
        c=torch.stack(st.c, -1), zplane=torch.stack(st.zplane, -1),
        inv_area=st.inv_area, inv_w=torch.stack(st.inv_w, -1),
        valid=st.valid, bbox=torch.stack(st.bbox, -1))


def _sum3(p0, p1, p2):
    """Left-associated 3-term sum of materialized products — vkr_tpu's
    reduction order (its stack+sum, setup.py:319-327). Eager PyTorch rounds
    every product, so no FMA contraction shifts the edge-equation
    cancellation by an ulp."""
    return (p0 + p1) + p2


def _guard(v):
    """v, with |v| < 1e-20 replaced by 1e-20 (the reference's division
    guard)."""
    return torch.where(v.abs() < 1e-20, 1e-20, v)


def corner_transform_t(cw_t, m):
    """(4, 3T) corner table x (4, 4) matrix -> (4, 3T) clip components in
    full float32 (TF32 is off; see frame.py)."""
    return torch.matmul(m, cw_t)


def world_positions(positions, transform_ids, transforms):
    """Model -> homogeneous world positions (V, 4) through the per-node
    transform table (N, 4, 4): upload_scene's corner tables gather these."""
    mats = transforms[transform_ids]
    pos_h = torch.cat([positions, torch.ones_like(positions[:, :1])], -1)
    return torch.matmul(mats, pos_h[..., None])[..., 0]


def transform_vertices(positions, transform_ids, transforms, view_proj):
    """Model -> clip transform for all vertices at once: (V, 4)
    (opaque_taa.vert:38, view_projection * model * pos). The projection is
    corner_transform_t on the (4, V) world table, the corner path's op."""
    world = world_positions(positions, transform_ids, transforms)
    return corner_transform_t(world.T.contiguous(), view_proj).T


def transform_normals(normals, transform_ids, normal_mats):
    """World-space unit normals via the per-node normal matrix
    (opaque_taa.vert:36)."""
    n = torch.matmul(normal_mats[transform_ids][:, :3, :3],
                     normals[..., None])[..., 0]
    return n / torch.linalg.vector_norm(n, dim=-1,
                                        keepdim=True).clamp(min=1e-20)


def corner_table(values, indices):
    """Per-vertex values (V, K) -> the corner table (K, 3T) of triangles
    indices (T, 3): component-major, corner c of every triangle in
    columns [c*T, (c+1)*T)."""
    return values[indices].permute(2, 1, 0).reshape(values.shape[1], -1)


def clip_near_triangles(clip, indices):
    """Near-plane clipping from a shared vertex set: the per-frame gather of
    the triangles' corners (clip[indices], the generic path), then
    clip_near_corners."""
    return clip_near_corners(clip[indices])


def clip_near_corners(tri):
    """Near-plane (z=0) clipping of (T, 3, 4) clip-space corners: every
    triangle yields up to two with all vertices at z >= 0. Returns
    (corners (2T, 3, 4), weights (2T, 3, 3) of each output corner over its
    source triangle's corners, src (2T,) source triangle ids, valid (2T,)).
    Output triangles i and i + T both come from source triangle i."""
    n = tri.shape[0]
    clip_t = tri.permute(2, 1, 0).reshape(4, 3 * n)
    tri2, weights_t, valid = clip_near_corners_t(clip_t, n)
    corners = corners_from_weights_t(tri2, weights_t)
    corners = torch.stack([torch.stack(corners[c], -1) for c in range(3)], 1)
    weights = torch.stack([torch.stack(weights_t[c], -1) for c in range(3)],
                          1)
    src = torch.arange(n, device=tri.device).repeat(2)
    return corners, weights, src, valid


def clip_near_corners_t(clip_t, n_src: int):
    """Near-plane (z=0) clipping on component-major corners: every source
    triangle yields up to two output triangles with all vertices at z >= 0.

    clip_t: (4, 3T) clip positions, corner-major columns. Returns
    (tri2 [3][4] of (2T,) source corner comps, weights [3][3] of (2T,),
    valid (2T,)). Output corner c is sum_m weights[c][m] * tri2[m]."""
    T = n_src
    tri = [[clip_t[j, c * T:(c + 1) * T] for j in range(4)]
           for c in range(3)]  # [corner][comp] (T,)
    z = [tri[c][2] for c in range(3)]
    i0, i1, i2 = (zc >= 0.0 for zc in z)
    n_inside = i0.int() + i1.int() + i2.int()

    def sel(cond, a, b):
        return torch.where(cond, a, b)

    rot_one = sel(i0, 0, sel(i1, 1, 2))
    rot_two = sel(~i0, 1, sel(~i1, 2, 0))
    rot = sel(n_inside == 1, rot_one, rot_two)  # (T,) int64

    def _cyc(vals, i):
        return sel(rot == 0, vals[i % 3],
                   sel(rot == 1, vals[(i + 1) % 3], vals[(i + 2) % 3]))

    zr = [_cyc(z, c) for c in range(3)]

    def lerp_t(za, zb):
        return za / _guard(za - zb)

    t01 = lerp_t(zr[0], zr[1])
    t12 = lerp_t(zr[1], zr[2])
    t02 = lerp_t(zr[0], zr[2])

    one = torch.ones_like(t01)
    zero = torch.zeros_like(t01)
    wA = [one, zero, zero]
    wB = [zero, one, zero]
    wC = [zero, zero, one]

    def mix(wa, wb, t):
        return [(1.0 - t) * a_ + t * b_ for a_, b_ in zip(wa, wb)]

    wAB = mix(wA, wB, t01)
    wBC = mix(wB, wC, t12)
    wAC = mix(wA, wC, t02)

    case3 = [wA, wB, wC]
    case1 = [wA, wAB, wAC]
    case2 = [wA, wB, wBC]
    m3 = n_inside == 3
    m1 = n_inside == 1
    w1 = [[sel(m3, case3[c][k], sel(m1, case1[c][k], case2[c][k]))
           for k in range(3)] for c in range(3)]
    w2 = [[[wA, wBC, wAC][c][k] for k in range(3)] for c in range(3)]

    def unrotate(w):
        return [[sel(rot == 0, w[c][k % 3],
                     sel(rot == 1, w[c][(k - 1) % 3], w[c][(k - 2) % 3]))
                 for k in range(3)] for c in range(3)]

    w1 = unrotate(w1)
    w2 = unrotate(w2)

    weights = [[torch.cat([w1[c][k], w2[c][k]]) for k in range(3)]
               for c in range(3)]  # [c][k] (2T,)
    tri2 = [[torch.cat([tri[m][j], tri[m][j]]) for j in range(4)]
            for m in range(3)]  # [src corner][comp] (2T,)
    valid = torch.cat([n_inside >= 1, n_inside == 2])
    return tri2, weights, valid


def corners_from_weights_t(tri2, weights):
    """out[c][j] = sum_m weights[c][m] * tri2[m][j]."""
    return [[_sum3(weights[c][0] * tri2[0][j],
                   weights[c][1] * tri2[1][j],
                   weights[c][2] * tri2[2][j])
             for j in range(4)] for c in range(3)]


def triangle_setup_t(corners, valid, width: int, height: int, jitter=None,
                     full_height: "int | None" = None, y_offset=None
                     ) -> TriangleSetupT:
    """Edge equations from clipped corners ([3][4] of (T,)). The TAA
    jitter (a (2,) tensor) moves raster coverage only (opaque_taa.vert:40).

    full_height/y_offset: the band viewport of multi-device rendering
    (vkr_tpu setup.py:193-217, :425-441): rows [y_offset, y_offset +
    height) of a full_height-tall frame. The edge and depth planes stay in
    full-frame coordinates, bit for bit those of the full frame; only the
    integer bbox rows are band-relative, so binning walks the band's tiles
    and the kernels add y_offset to their pixel rows."""
    y_off = 0 if y_offset is None else y_offset
    inv_w, x, y, d = [], [], [], []
    for c in range(3):
        iw = 1.0 / _guard(corners[c][3])
        ndc = [corners[c][j] * iw for j in range(3)]
        if jitter is not None:
            ndc[0] = ndc[0] + jitter[0]
            ndc[1] = ndc[1] + jitter[1]
        inv_w.append(iw)
        x.append((ndc[0] * 0.5 + 0.5) * width)
        y.append((ndc[1] * 0.5 + 0.5) * (full_height or height))
        d.append(ndc[2])

    area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
    s = torch.where(area >= 0.0, 1.0, -1.0)
    abs_area = area.abs()
    ok = valid & (abs_area > 1e-12)

    a, b, cc, c_unb = [], [], [], []
    for j, k in ((1, 2), (2, 0), (0, 1)):  # edge i opposite corner i
        ai = -(y[k] - y[j]) * s
        bi = (x[k] - x[j]) * s
        ci = ((y[k] - y[j]) * x[j] - (x[k] - x[j]) * y[j]) * s
        # Vulkan top-left fill rule (y-down): an edge is inclusive iff it
        # is a left edge (a > 0) or a top edge (a == 0 and b > 0)
        inclusive = (ai > 0.0) | ((ai == 0.0) & (bi > 0.0))
        edge_len = torch.sqrt(ai * ai + bi * bi)
        a.append(ai)
        b.append(bi)
        c_unb.append(ci)
        cc.append(torch.where(inclusive, ci, ci - _FILL_EPS * edge_len))

    inv_area = 1.0 / _guard(abs_area)
    za = _sum3(a[0] * d[0], a[1] * d[1], a[2] * d[2]) * inv_area
    zb = _sum3(b[0] * d[0], b[1] * d[1], b[2] * d[2]) * inv_area
    zc = _sum3(c_unb[0] * d[0], c_unb[1] * d[1], c_unb[2] * d[2]) * inv_area

    xmin = torch.minimum(torch.minimum(x[0], x[1]), x[2])
    xmax = torch.maximum(torch.maximum(x[0], x[1]), x[2])
    ymin = torch.minimum(torch.minimum(y[0], y[1]), y[2])
    ymax = torch.maximum(torch.maximum(y[0], y[1]), y[2])
    x0 = torch.floor(xmin - 0.5).clamp(0, width - 1)
    x1 = torch.ceil(xmax - 0.5).clamp(0, width - 1)
    y0, y1 = torch.floor(ymin - 0.5), torch.ceil(ymax - 0.5)
    if y_off:  # band rows (the whole frame makes no extra kernel)
        y0, y1 = y0 - y_off, y1 - y_off
    y0, y1 = y0.clamp(0, height - 1), y1.clamp(0, height - 1)
    offscreen = ((xmax < 0.5) | (xmin > width - 0.5)
                 | (ymax < y_off + 0.5) | (ymin > y_off + height - 0.5))
    ok = ok & ~offscreen
    # a NaN corner (degenerate clip) gives a NaN bbox; such triangles are
    # invalid, and 0 keeps their int conversion defined
    bbox = [torch.nan_to_num(v, nan=0.0).to(torch.int32)
            for v in (x0, y0, x1, y1)]

    return TriangleSetupT(a=a, b=b, c=cc, zplane=[za, zb, zc],
                          inv_area=inv_area, inv_w=inv_w, valid=ok,
                          bbox=bbox)


def triangle_setup(corners, valid, width: int, height: int, jitter=None,
                   full_height: "int | None" = None, y_offset=None
                   ) -> TriangleSetup:
    """triangle_setup_t on row-major corners (TC, 3, 4)."""
    cols = [[corners[:, c, j] for j in range(4)] for c in range(3)]
    return _rowmajor(triangle_setup_t(cols, valid, width, height, jitter,
                                      full_height, y_offset))


class PairPlan:
    """The bin-pair capacities of one frame's binning calls, in call order.
    capacities None records each call's exact pair count (one host read,
    as the eager frame reads it); a list gives each call its capacity with
    no host read."""

    def __init__(self, capacities=None):
        self.capacities = None if capacities is None else list(capacities)
        self.counts = []

    def capacity(self, total) -> int:
        if self.capacities is None:
            self.counts.append(int(total))
            return max(self.counts[-1], 1)
        i = len(self.counts)
        if i >= len(self.capacities):
            raise RuntimeError(f"bin_triangles_t: binning call {i + 1} of a "
                               f"frame planned for {len(self.capacities)}")
        self.counts.append(None)
        return self.capacities[i]


_PLAN: contextvars.ContextVar = contextvars.ContextVar("pair_plan",
                                                       default=None)


@contextlib.contextmanager
def pair_plan(plan: PairPlan):
    """Within: every bin_triangles_t call without a pair_capacity takes its
    capacity from `plan` (the captured frame's binning)."""
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)


def static_capacities(counts) -> list:
    """The captured frame's capacities for the exact pair counts of its
    capture frame: count * PAIR_HEADROOM, at least PAIR_FLOOR."""
    return [max(math.ceil(n * PAIR_HEADROOM), PAIR_FLOOR) for n in counts]


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  tile_h: int, tile_w: int, pair_capacity: "int | None"):
    """bin_triangles_t on the row-major setup (vkr_tpu's bin_triangles)."""
    return bin_triangles_t([setup.bbox[:, i] for i in range(4)],
                           setup.valid, width, height, tile_h, tile_w,
                           pair_capacity)


def bin_triangles_t(bbox, valid, width: int, height: int, tile_h: int,
                    tile_w: int, pair_capacity: "int | None"):
    """Expand triangles into per-tile work lists (sorted segment layout).

    bbox: [4] of (T,) int32; valid: (T,) bool. Each valid triangle emits one
    pair per tile its bbox touches; pairs beyond pair_capacity are dropped
    and counted (vkr_tpu's jnp.repeat(..., total_repeat_length=cap)
    truncation). pair_capacity None sizes the list to the pairs there are
    (one host read of their count), so none is dropped, or inside
    pair_plan() takes the plan's capacity. In-tile order is ascending
    triangle id, which decides LESS_OR_EQUAL depth ties.

    Returns (pair_tri (CAP,) int32 sorted segment layout (-1 = padding),
    seg_starts (n_tiles,) int32, seg_counts (n_tiles,) int32,
    overflow () int32 — dropped pairs, 0 in healthy runs).
    """
    dev = valid.device
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y
    n_tri = valid.shape[0]
    if n_tri == 0:
        cap = 1 if pair_capacity is None else pair_capacity
        zeros = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        return (torch.full((cap,), -1, dtype=torch.int32, device=dev),
                zeros, zeros.clone(),
                torch.zeros((), dtype=torch.int32, device=dev))

    bx0 = bbox[0].long() // tile_w
    by0 = bbox[1].long() // tile_h
    bx1 = bbox[2].long() // tile_w
    by1 = bbox[3].long() // tile_h
    wspan = torch.where(valid, bx1 - bx0 + 1, 0)
    hspan = torch.where(valid, by1 - by0 + 1, 0)
    counts = wspan * hspan  # (T,)
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    if pair_capacity is not None:
        cap = pair_capacity
    elif _PLAN.get() is not None:
        cap = _PLAN.get().capacity(total)
    else:
        cap = max(int(total), 1)

    # slot -> emitting triangle: the repeat of triangle ids by counts,
    # truncated to the capacity (a search, so no host sync)
    slot = torch.arange(cap, dtype=torch.long, device=dev)
    tri = torch.searchsorted(ends, slot, right=True).clamp(max=n_tri - 1)
    pair_valid = slot < total.clamp(max=cap)
    kk = slot - (ends - counts)[tri]
    w1 = wspan.clamp(min=1)[tri]
    tx = bx0[tri] + kk % w1
    ty = by0[tri] + kk // w1
    tile_id = torch.where(pair_valid, ty * tiles_x + tx, n_tiles)

    # one int64 key sort = stable sort by (tile, triangle id)
    shift = max(n_tri, 1).bit_length()
    skey, _ = torch.sort((tile_id << shift) | tri)
    tile_sorted = skey >> shift
    pair_tri_sorted = torch.where(
        tile_sorted < n_tiles, skey & ((1 << shift) - 1), -1
    ).to(torch.int32)

    offsets = torch.searchsorted(
        tile_sorted, torch.arange(n_tiles + 1, dtype=torch.long, device=dev),
        side="left")
    seg_counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    seg_starts = offsets[:-1].to(torch.int32)
    overflow = torch.clamp(total - cap, min=0).to(torch.int32)
    return pair_tri_sorted, seg_starts, seg_counts, overflow
