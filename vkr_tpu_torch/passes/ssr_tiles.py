"""SSR tile classification + per-tile plane regression.

Reference: shaders/advanced_ssr/{classification,regression,trace_indirect}
.comp (+ the numpy prototype pyscript/debug_regression.py);
vkr_tpu/passes/ssr_tiles.py. The indirect-dispatch tile path that the
reference constructs but leaves disabled in AdvancedSSR::run
(advanced_ssr.cpp:540-554). As in vkr_tpu, the atomic-append tile lists
become a dense tile-class mask plus compacted index lists, and "dispatch
indirect" becomes dense masked execution over the tile grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.octahedral import decode_normal
from vkr_tpu_torch.mathlib.projection import (linearize_depth,
                                              reconstruct_view_vec)
from vkr_tpu_torch.passes.sampling import (bilinear_from_quad,
                                          downsample_full_to_half, quad_pack,
                                          screen_uv_grid)

TILE = 8  # classification.comp TILE_SIZE


class TileClassification(NamedTuple):
    """classification.comp output: mirror-vs-glossy tile partition."""

    avg_roughness: torch.Tensor     # (tiles_y, tiles_x) f32
    is_reflective: torch.Tensor     # (tiles_y, tiles_x) bool
    reflective_tiles: torch.Tensor  # (n_tiles,) i32 packed ids (pad -1)
    reflective_count: torch.Tensor  # () i32
    glossy_tiles: torch.Tensor      # (n_tiles,) i32 packed ids (pad -1)
    glossy_count: torch.Tensor      # () i32


def _tile_sum(a):
    """Sum over each tile's 8x8 texels, (ty, 8, tx, 8, ...) -> (ty, tx,
    ...), in XLA's order for a reduce over axes (1, 3): row by row, each
    row left to right, one running float32 sum."""
    acc = a[:, 0, :, 0]
    for i in range(TILE):
        for j in range(TILE):
            if i or j:
                acc = acc + a[:, i, :, j]
    return acc


@register("sssr_classification")
def classify_tiles(material_full, max_roughness: float,
                   glossy_value: float) -> TileClassification:
    """Per-8x8-tile roughness vote (classification.comp): tiles whose mean
    biased roughness < glossy_value go to the reflective (mirror) list."""
    h, w = material_full.shape[:2]
    ty, tx = h // TILE, w // TILE
    rough = material_full[: ty * TILE, : tx * TILE, 1] * max_roughness
    avg = _tile_sum(rough.reshape(ty, TILE, tx, TILE)) / (TILE * TILE)
    is_refl = avg < glossy_value

    n_tiles = ty * tx
    flat = is_refl.reshape(-1)
    # compact both partitions: a stable sort by class puts members first,
    # each in tile order
    refl_order = torch.argsort((~flat).to(torch.uint8), stable=True)
    glossy_order = torch.argsort(flat.to(torch.uint8), stable=True)
    refl_count = flat.sum().to(torch.int32)
    glossy_count = (n_tiles - refl_count).to(torch.int32)
    slot = torch.arange(n_tiles, dtype=torch.int32, device=flat.device)
    refl_tiles = torch.where(slot < refl_count, refl_order.to(torch.int32),
                             -1)
    glossy_tiles = torch.where(slot < glossy_count,
                               glossy_order.to(torch.int32), -1)
    return TileClassification(
        avg_roughness=avg, is_reflective=is_refl,
        reflective_tiles=refl_tiles, reflective_count=refl_count,
        glossy_tiles=glossy_tiles, glossy_count=glossy_count)


@register("tile_regression")
def tile_plane_regression(depth, camera_to_world, fovy, aspect, znear,
                          zfar):
    """Per-8x8-tile least-squares plane fit (regression.comp): solve the
    3x3 normal equations for plane p with dot(p, x_i) = 1 over the tile's
    camera-relative world points; returns (tiles_y, tiles_x, 4) = (plane
    xyz, mean squared error, NaN errors counted as 1e10).

    The shared-memory reduction becomes tile sums; the 3x3 inverse is the
    closed-form adjugate (pyscript/debug_regression.py)."""
    h, w = depth.shape
    dev = depth.device
    ty, tx = h // TILE, w // TILE
    # NOTE: regression.comp uses uv = pixel/size (no half-texel)
    xs = torch.arange(w, dtype=torch.float32, device=dev) / w
    ys = torch.arange(h, dtype=torch.float32, device=dev) / h
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([xx, yy], dim=-1)
    view_vec = reconstruct_view_vec(uv, depth, fovy, aspect, znear, zfar)
    m = camera_to_world
    pts = view_vec @ m[:3, :3].T  # world_vec - world_origin

    p = pts[: ty * TILE, : tx * TILE].reshape(ty, TILE, tx, TILE, 3)

    s = _tile_sum(p)                       # sum x_i
    sq = _tile_sum(p * p)                  # sum x^2, y^2, z^2
    xy = _tile_sum(p[..., 0] * p[..., 1])
    xz = _tile_sum(p[..., 0] * p[..., 2])
    yz = _tile_sum(p[..., 1] * p[..., 2])

    a11, a22, a33 = sq[..., 0], sq[..., 1], sq[..., 2]
    a12, a13, a23 = xy, xz, yz
    # closed-form inverse of the symmetric 3x3
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)

    bx, by, bz = s[..., 0], s[..., 1], s[..., 2]
    plane = torch.stack([
        (c11 * bx + c12 * by + c13 * bz) * inv_det,
        (c12 * bx + c22 * by + c23 * bz) * inv_det,
        (c13 * bx + c23 * by + c33 * bz) * inv_det,
    ], dim=-1)  # (ty, tx, 3)

    q = plane[:, None, :, None, :]
    err = (q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1]
           + q[..., 2] * p[..., 2]) - 1.0
    err = err * err
    err = torch.where(torch.isnan(err), 1e10, err)
    mse = _tile_sum(err) / (TILE * TILE)
    return torch.cat([plane, mse[..., None]], dim=-1)


@register("sssr_trace_indirect")
def ssr_trace_indirect(hiz, normal_half, material_full, params,
                       frame_random, halton, classification,
                       reflection_type: int = 0):
    """trace_indirect.comp:44-134 — the specialised reflection trace that
    consumes the classification pass's tile lists. reflection_type 0 =
    mirror tiles (plain hierarchical march from mip 0, 50 iterations, and
    a hit-depth tolerance test), 1 = glossy tiles (from mip 1, 25
    iterations). Dense masked execution: every pixel computes, and pixels
    whose 8x8 tile is not in the requested class come out as the shader's
    initializer (0, 0, 1, 1). The reference builds this pipeline but leaves
    it disabled (advanced_ssr.cpp:540-554); registered for manifest parity
    (config.json sssr_trace_indirect).

    hiz: ssr.FlatPyramid; params: ssr.SSRParams; frame_random: int;
    classification: the sssr_classification output. Returns ray_info
    (h, w, 4)."""
    from vkr_tpu_torch.passes.ssr import _reflection_ray_setup
    from vkr_tpu_torch.passes.ssr_march import hierarchical_march_plain

    h, w = hiz.heights[0], hiz.widths[0]
    dev = hiz.flat.device
    uv = screen_uv_grid(h, w, dev)
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    depth_base = hiz.flat[: h * w].reshape(h, w)

    material = downsample_full_to_half(material_full)[:h, :w]
    biased = params.max_roughness * material[..., 1]
    roughness = biased * biased

    view_vec, w0, n, r, ray_start, ray_dir = _reflection_ray_setup(
        uv, depth_base, normal_half, roughness, params, frame_random,
        halton)

    mirror = reflection_type == 0
    max_iters = 50 if mirror else 25
    position, iters = hierarchical_march_plain(
        hiz, ray_start, ray_dir, max_iters,
        most_detailed_mip=0 if mirror else 1)
    valid_hit = iters <= max_iters

    # trace_indirect.comp:106-130 validations
    ray_step = (position[..., :2] - ray_start[..., :2]).abs() * size
    valid_hit = valid_hit & (torch.maximum(ray_step[..., 0],
                                           ray_step[..., 1]) >= 2.0)
    nm = params.normal_mat
    hit_n = decode_normal(bilinear_from_quad(
        quad_pack(normal_half), 2, position[..., :2])) @ nm[:3, :3].T
    valid_hit = valid_hit & ~(((hit_n * r).sum(-1) > 0)
                              | ((n * r).sum(-1) < 0))
    if mirror:
        hit_depth = bilinear_from_quad(quad_pack(depth_base), 1,
                                       position[..., :2])[..., 0]
        hit_z = linearize_depth(hit_depth, params.znear, params.zfar)
        ray_z = linearize_depth(position[..., 2], params.znear, params.zfar)
        valid_hit = valid_hit & ~((ray_z > hit_z + 0.3)
                                  | (ray_z < hit_z - 0.1))

    in_class = trace_indirect_mask(classification, h, w)
    if not mirror:
        in_class = ~in_class
    ray_info = torch.cat(
        [position, torch.where(valid_hit, depth_base, 1.0)[..., None]], -1)
    untouched = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    return torch.where(in_class[..., None], ray_info, untouched)


def trace_indirect_mask(classification: TileClassification, height: int,
                        width: int):
    """The dispatch_indirect analog: a per-pixel mask of the reflective
    (mirror) tiles, for dense masked execution of the mirror-ray
    variant."""
    m = classification.is_reflective
    return m.repeat_interleave(TILE, dim=0).repeat_interleave(
        TILE, dim=1)[:height, :width]
