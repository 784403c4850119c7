"""K7 — the visibility-only tile raster (depth and triangle id), and its
plain PyTorch version.

Per screen tile, the binned pair segment is walked in order: coverage from
the three edge functions plus 0 <= d <= 1, and a LESS_OR_EQUAL depth test
(d <= zbuf) against the 1.0 clear. No attributes are resolved. The
shadow-map pass was its caller; the benchmark keeps it for raster/pipeline.

Replaces vkr_tpu/raster/kernel.py:_raster_kernel (pallas_call at :184,
wrapper rasterize_tiles :145). The CUDA kernel is K1's tile walk in
csrc/gbuf_tiles.cu with the resolve and the peel floor compiled out, so
its planes take K1's fma form (gbuf_kernel.plane).

Also the brute-force oracle raster behind vkr_tpu's use_pallas=False
(rasterize_reference, vkr_tpu kernel.py:198): no binning, every triangle
over every pixel.
"""

from __future__ import annotations

import torch

from vkr_ref import kernels
from vkr_ref.raster.gbuf_kernel import (_TRI_ID, _tiles, plane,
                                             walk_reference, walk_scratch)
from vkr_ref.raster.pair_rows import ROW_WIDTH


def rasterize_tiles(pair_rows, seg_starts, seg_counts, *, width: int,
                    height: int, tile_h: int = 8, tile_w: int = 128,
                    row_offset: int = 0):
    """Run the visibility raster over binned pair segments.

    pair_rows: (n_pairs, 64) f32 (or vkr_tpu's (n_rows, 128) view of it);
    only the raster fields [0:13) are read. seg_starts/seg_counts:
    (n_tiles,) int32, tiles row-major. row_offset: the band's first pixel
    row in the full frame (vkr_tpu kernel.py:149-168, yoff at :95).

    Returns (zbuf (H', W') f32, 1.0 clear; tri_id (H', W') int32, -1 none)
    on the tile-aligned grid; crop to (height, width).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    rows = pair_rows.reshape(-1, ROW_WIDTH)
    tiles_x, tiles_y, hp, wp = _tiles(width, height, tile_h, tile_w)
    if True:  # frozen copy: the plain version on every device
        return rasterize_tiles_reference(rows, seg_starts, seg_counts,
                                         width=width, height=height,
                                         tile_h=tile_h, tile_w=tile_w,
                                         row_offset=row_offset)
    if not rows.is_cuda:
        raise ValueError(f"rasterize_tiles: unsupported device {rows.device}")
    n_tiles = tiles_x * tiles_y
    for name, t, dtype, shape in (
            ("pair_rows", rows, torch.float32, None),
            ("seg_starts", seg_starts, torch.int32, (n_tiles,)),
            ("seg_counts", seg_counts, torch.int32, (n_tiles,))):
        if t.device != rows.device or t.dtype != dtype:
            raise ValueError(f"rasterize_tiles: {name} must be {dtype} on "
                             f"{rows.device}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"rasterize_tiles: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"rasterize_tiles: {name} must be contiguous")
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=rows.device)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=rows.device)
    keys, table = walk_scratch(rows, n_tiles, tile_h, tile_w, hp, wp,
                               "rasterize_tiles")
    err = kernels.library("gbuf_tiles").vkr_rasterize_tiles(
        rows.data_ptr(), seg_starts.data_ptr(), seg_counts.data_ptr(),
        tiles_x, tiles_y, tile_h, tile_w, int(row_offset), zbuf.data_ptr(),
        tid.data_ptr(), keys.data_ptr(), table.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    kernels.check(err, "rasterize_tiles")
    kernels.LAUNCHES["rasterize_tiles"] += 1
    return zbuf, tid


def rasterize_tiles_reference(pair_rows, seg_starts, seg_counts, *,
                              width: int, height: int, tile_h: int = 8,
                              tile_w: int = 128, chunk_evals: int = 1 << 24,
                              row_offset: int = 0):
    """Plain version of rasterize_tiles (same arguments and results, any
    device): gbuf_kernel.walk_reference without a peel floor."""
    rows = pair_rows.reshape(-1, ROW_WIDTH)
    tiles_x, _, hp, wp = _tiles(width, height, tile_h, tile_w)
    no_peel = torch.full((hp * wp,), -1.0, dtype=torch.float32,
                         device=rows.device)
    zbuf, win = walk_reference(rows, seg_starts, seg_counts, no_peel,
                               tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w,
                               chunk_evals=chunk_evals, row_offset=row_offset)
    won = rows[win.clamp(min=0), _TRI_ID] if rows.shape[0] else -1.0
    tid = torch.where(win >= 0, won, -1.0).to(torch.int32)
    return zbuf.reshape(hp, wp), tid.reshape(hp, wp)


def rasterize_reference(setup, width: int, height: int, peel_depth=None,
                        chunk_evals: int = 1 << 22, row_offset: int = 0):
    """Brute-force raster of a row-major setup.TriangleSetup (no binning):
    the oracle behind vkr_tpu's use_pallas=False. Every valid triangle's
    edge and depth planes (K1's fma form, gbuf_kernel.plane) over every
    pixel centre (rows row_offset + r: a band of the full frame, vkr_tpu
    kernel.py:199-207), coverage 0 <= d <= 1 and d above the optional peel
    floor (H, W), LESS_OR_EQUAL in triangle order: the winner is the nearest
    covering triangle, the later one on a tie. O(T * pixels), in chunks of
    about chunk_evals triangle-pixels: tests and small scenes.

    Returns (zbuf (H, W) f32, 1.0 clear; tri_id (H, W) int32, -1 none)."""
    dev = setup.a.device
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(row_offset, row_offset + height, dtype=torch.float32,
                      device=dev)[:, None] + 0.5
    zbuf = torch.ones((height, width), dtype=torch.float32, device=dev)
    tid = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    peel = -1.0 if peel_depth is None else peel_depth
    n_tri = setup.a.shape[0]
    step = max(1, chunk_evals // (width * height))
    for lo in range(0, n_tri, step):
        sl = slice(lo, lo + step)
        a, b, c = (x[sl, :, None, None] for x in (setup.a, setup.b,
                                                   setup.c))
        z = setup.zplane[sl, :, None, None]
        d = plane(z[:, 0], z[:, 1], z[:, 2], px, py)
        cover = ((d >= 0.0) & (d <= 1.0) & (d > peel)
                 & setup.valid[sl, None, None])
        for i in range(3):
            cover &= plane(a[:, i], b[:, i], c[:, i], px, py) >= 0.0
        d = torch.where(cover, d, torch.inf)
        dmin = d.min(0).values
        ids = torch.arange(lo, lo + d.shape[0], dtype=torch.int32,
                           device=dev)[:, None, None]
        last = torch.where(d == dmin, ids, -1).max(0).values
        take = dmin <= zbuf
        zbuf = torch.where(take, dmin, zbuf)
        tid = torch.where(take, last, tid)
    return zbuf, tid
