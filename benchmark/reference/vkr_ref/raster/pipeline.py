"""Raster pipeline: geometry in, visibility + resolved attributes out.

Ties together near clip -> setup -> binning -> pair rows -> the merged
raster + resolve kernel (K1), or, without attributes, the visibility-only
kernel (K7). The analog of the reference's per-frame G-buffer draw
(scene_renderer.cpp:140-215); vkr_tpu/raster/pipeline.py:46. Two front
ends feed the kernels, as in vkr_tpu: pre-gathered corner tables (the
static-scene path, corners_t) and the indexed one (clip + indices,
:140-147 and :168-201), which gathers the triangles' corners and
attributes from the vertex arrays every frame into the same corner
tables, so the two give the same pair rows by construction. The oracle
(:216) skips binning and the kernels for the brute-force raster
(kernel.rasterize_reference) and leaves the attributes to the gather
resolve (resolve.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vkr_ref.raster import gbuf_kernel as _gk
from vkr_ref.raster import kernel as _kernel
from vkr_ref.raster import pair_rows as _rows
from vkr_ref.raster import setup as _setup


class RasterPrepared(NamedTuple):
    """Everything K1 needs, independent of peel_depth."""

    pair_rows: torch.Tensor   # (CAP, 64) f32
    seg_starts: torch.Tensor  # (n_tiles,) int32
    seg_counts: torch.Tensor  # (n_tiles,) int32


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor      # (H, W) f32 hardware depth, 1.0 = background
    tri_id: torch.Tensor     # (H, W) int32 clipped-triangle id, -1 = none
    overflow: torch.Tensor   # () int32 dropped bin pairs (0 = healthy)
    # (N_CHANNELS + 1, H, W) = [uv(2), normal(3), prev_clip(4), mat_id];
    # None for a visibility-only raster
    resolved: Optional[torch.Tensor]
    # front-end products kept for a kernel rerun (the depth-peel layer);
    # None unless keep_prepared=True
    prepared: Optional[RasterPrepared] = None
    # the oracle's clipped-triangle records for the gather resolve: the
    # row-major setup.TriangleSetup, near-clip weights (TC, 3, 3) and
    # source triangle ids (TC,); None on the kernel paths
    setup: Optional[_setup.TriangleSetup] = None
    weights: Optional[torch.Tensor] = None
    src: Optional[torch.Tensor] = None




def rasterize(
    corners_t=None,
    corner_attrs_t=None,
    tri_mat=None,
    *,
    width: int,
    height: int,
    tile_h: int = 8,
    tile_w: int = 128,
    jitter=None,
    peel_depth=None,
    keep_prepared: bool = False,
    prepared: Optional[VisibilityBuffer] = None,
    clip=None,
    indices=None,
    vertex_attrs=None,
    oracle: bool = False,
    full_height: Optional[int] = None,
    y_offset: int = 0,
) -> VisibilityBuffer:
    """Rasterize T triangles given as pre-gathered corners, or indexed.

    corners_t (4, 3T): clip positions, component-major, corner-major
    columns [c*T, (c+1)*T); corner_attrs_t (9, 3T): per-corner attributes
    (uv 2, world normal 3, previous clip 4) in the same layout;
    tri_mat (T,) int32 material ids. With corner_attrs_t None the raster
    is visibility only (depth and clipped-triangle id, K7): resolved is
    None, and peel_depth / prepared do not apply.
    Indexed front end (corners_t None): clip (V, 4) clip positions,
    indices (T, 3) vertex ids, vertex_attrs (V, 9) per-vertex attributes
    in corner_attrs_t's channel order (None: visibility only), gathered
    into corners_t / corner_attrs_t.
    oracle: the brute-force raster instead of binning and the kernels
    (indexed only; vkr_tpu's use_pallas=False): resolved is None, and
    setup/weights/src are set for resolve.py; peel_depth applies.
    jitter: optional (2,) NDC offset applied to coverage only (TAA).
    The bin-pair list is sized to the pairs there are (one host read of
    their count per call), so overflow is 0: vkr_tpu's static capacity
    max(1.5 T, 4 n_tiles, 4096), a fixed shape for XLA, drops the pairs of
    low-poly scenes at 1080p (the tools' 8-column colonnade: 28,843 of
    43,837 at orbit frame 0). Inside setup.pair_plan (the captured frame,
    core/aot.py) the list has the plan's static capacity instead, with no
    host read, and overflow counts the pairs beyond it on the device, as
    vkr_tpu's does.
    peel_depth: optional (H, W) f32 — only fragments strictly BEHIND it
    survive (depth peeling).
    keep_prepared: keep the pair rows + segment table on the result.
    prepared: a prior VisibilityBuffer of the SAME geometry and camera,
    built with keep_prepared=True — skip the front end and rerun only K1
    (the peel pass differs from the first masked pass only in peel_depth).
    full_height/y_offset: the band viewport (vkr_tpu pipeline.py:59-218):
    rows [y_offset, y_offset + height) of a full_height-tall frame, bit for
    bit those rows of the full frame (setup.triangle_setup_t).
    """
    kw = dict(width=width, height=height, tile_h=tile_h, tile_w=tile_w,
              row_offset=y_offset)
    band = dict(full_height=full_height, y_offset=y_offset)
    if corners_t is None and prepared is None:
        if oracle:
            return _oracle(clip, indices, jitter, peel_depth, width, height,
                           band)
        corners_t = _setup.corner_table(clip, indices)
        if vertex_attrs is not None:
            corner_attrs_t = _setup.corner_table(vertex_attrs, indices)
    elif oracle:
        raise ValueError("the oracle raster takes the indexed front end "
                         "(clip and indices)")
    visibility_only = corner_attrs_t is None and prepared is None
    if visibility_only and (peel_depth is not None or keep_prepared):
        raise ValueError("peel_depth and keep_prepared need the merged "
                         "raster + resolve (pass corner_attrs_t)")
    if prepared is not None:
        if prepared.prepared is None:
            raise ValueError("prepared= rerun requires a VisibilityBuffer "
                             "built with keep_prepared=True")
        prep = prepared.prepared
        overflow = torch.zeros((), dtype=torch.int32,
                               device=prep.pair_rows.device)
    else:
        n_src = corners_t.shape[1] // 3
        tri2, weights_t, valid = _setup.clip_near_corners_t(corners_t, n_src)
        corners_c = _setup.corners_from_weights_t(tri2, weights_t)
        setup_t = _setup.triangle_setup_t(corners_c, valid, width, height,
                                          jitter, **band)
        pair_tri, seg_starts, seg_counts, overflow = _setup.bin_triangles_t(
            setup_t.bbox, setup_t.valid, width, height, tile_h, tile_w,
            None)
        if visibility_only:
            tri_rows = _rows.build_tri_rows_t(setup_t)
            zbuf, tid = _kernel.rasterize_tiles(
                _rows.expand_pair_rows(tri_rows, pair_tri), seg_starts,
                seg_counts, **kw)
            return VisibilityBuffer(depth=zbuf[:height, :width],
                                    tri_id=tid[:height, :width],
                                    overflow=overflow, resolved=None)
        # clipped triangle i and i + T both come from source triangle i
        mat2 = torch.cat([tri_mat, tri_mat])
        cattrs_t = _rows.corner_attributes_pre_t(corner_attrs_t, weights_t,
                                                 n_src)
        tri_rows = _rows.build_tri_rows_t(setup_t, cattrs_t, mat2)
        prep = RasterPrepared(_rows.expand_pair_rows(tri_rows, pair_tri),
                              seg_starts, seg_counts)
    zbuf, tid, attrs = _gk.gbuf_tiles(prep.pair_rows, prep.seg_starts,
                                      prep.seg_counts, peel_depth, **kw)
    return VisibilityBuffer(
        depth=zbuf[:height, :width], tri_id=tid[:height, :width],
        overflow=overflow, resolved=attrs[:, :height, :width],
        prepared=prep if keep_prepared else None,
    )


def _oracle(clip, indices, jitter, peel_depth, width, height, band):
    """The brute-force raster of the indexed triangles, with the records
    the gather resolve needs."""
    corners, weights, src, valid = _setup.clip_near_triangles(clip, indices)
    setup = _setup.triangle_setup(corners, valid, width, height, jitter,
                                  **band)
    zbuf, tid = _kernel.rasterize_reference(setup, width, height,
                                            peel_depth=peel_depth,
                                            row_offset=band["y_offset"])
    return VisibilityBuffer(
        depth=zbuf, tri_id=tid,
        overflow=torch.zeros((), dtype=torch.int32, device=zbuf.device),
        resolved=None, setup=setup, weights=weights, src=src)
