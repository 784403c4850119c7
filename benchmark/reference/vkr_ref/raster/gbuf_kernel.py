"""K1 — the merged tile raster + attribute-resolve kernel, and its plain
PyTorch version.

One walk over each tile's binned pair segment performs the depth test and
picks the winning pair per pixel; the winner's resolve planes (perspective
denominator, 9 attribute/w planes, material id) are evaluated once per
pixel: perspective-correct interpolation, every channel a plane (p, q, r)
in screen (x, y) divided by the denominator plane.

Replaces vkr_tpu/raster/gbuf_kernel.py:_gbuf_kernel (pallas_call at :202,
wrapper gbuf_tiles :145). The CUDA kernel is csrc/gbuf_tiles.cu.
"""

from __future__ import annotations

import torch

from vkr_ref import kernels
from vkr_ref.core.constants import constant
from vkr_ref.raster.pair_rows import (
    N_CHANNELS,
    RESOLVE_BASE,
    ROW_WIDTH,
)

_TRI_ID = 12
_MATERIAL = RESOLVE_BASE + 3 + 3 * N_CHANNELS  # 46
# background resolve planes: denominator (0, 0, 1), channels 0, material -1
_BACKGROUND = [0.0, 0.0, 1.0] + [0.0] * (3 * N_CHANNELS) + [-1.0]


def plane(a, b, c, px, py):
    """Evaluate the screen-space plane a*px + b*py + c as fma(a, px, b*py)
    + c: the contraction vkr_tpu's kernel gets from XLA (every covered
    pixel of its interpret-mode output matches this form, not the
    separately rounded one). The fma is exact in float64 — a*px has at most
    48 significant bits — then rounded once to float32 (a double rounding
    can differ from a true fma only when the float64 sum itself was
    inexact and lands on a float32 tie). The CUDA kernel calls fmaf."""
    t = (b * py).double()
    return (a.double() * px.double() + t).float() + c


def _tiles(width, height, tile_h, tile_w):
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    return tiles_x, tiles_y, tiles_y * tile_h, tiles_x * tile_w


def _peel_floor(peel_depth, hp, wp, device):
    """(hp, wp) peel floor: -1 (no peeling) outside peel_depth."""
    peel = torch.full((hp, wp), -1.0, dtype=torch.float32, device=device)
    if peel_depth is not None:
        peel[:peel_depth.shape[0], :peel_depth.shape[1]] = peel_depth
    return peel


def gbuf_tiles(pair_rows, seg_starts, seg_counts, peel_depth=None, *,
               width: int, height: int, tile_h: int = 8, tile_w: int = 128,
               row_offset: int = 0):
    """Run the merged raster + resolve over binned pair segments.

    pair_rows: (n_pairs, 64) f32 (or vkr_tpu's (n_rows, 128) view of it);
    seg_starts/seg_counts: (n_tiles,) int32, tiles row-major;
    peel_depth: optional (height, width) f32 — only fragments strictly
    BEHIND it survive (the alpha-MASK depth-peel layer).
    row_offset: the band's first pixel row in the full frame (band
    viewports, vkr_tpu gbuf_kernel.py:150-182): the planes are evaluated at
    rows row_offset + r, the outputs hold the band's rows.

    Returns (zbuf (H', W') f32, tri_id (H', W') int32,
    attrs (N_CHANNELS + 1, H', W') f32 = [uv(2), normal(3), prev_clip(4),
    mat_id]) on the tile-aligned grid; crop to (height, width).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    rows = pair_rows.reshape(-1, ROW_WIDTH)
    tiles_x, tiles_y, hp, wp = _tiles(width, height, tile_h, tile_w)
    if True:  # frozen copy: the plain version on every device
        return gbuf_tiles_reference(rows, seg_starts, seg_counts, peel_depth,
                                    width=width, height=height,
                                    tile_h=tile_h, tile_w=tile_w,
                                    row_offset=row_offset)
    if not rows.is_cuda:
        raise ValueError(f"gbuf_tiles: unsupported device {rows.device}")
    n_tiles = tiles_x * tiles_y
    for name, t, dtype, shape in (
            ("pair_rows", rows, torch.float32, None),
            ("seg_starts", seg_starts, torch.int32, (n_tiles,)),
            ("seg_counts", seg_counts, torch.int32, (n_tiles,))):
        if t.device != rows.device or t.dtype != dtype:
            raise ValueError(f"gbuf_tiles: {name} must be {dtype} on "
                             f"{rows.device}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"gbuf_tiles: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
        if not t.is_contiguous():
            raise ValueError(f"gbuf_tiles: {name} must be contiguous")
    if peel_depth is not None and (peel_depth.dtype != torch.float32
                                   or peel_depth.device != rows.device
                                   or peel_depth.ndim != 2):
        raise ValueError("gbuf_tiles: peel_depth must be 2-D float32 on "
                         f"{rows.device}")
    # the kernel reads the floor in place: -1 (none) outside it
    peel = None if peel_depth is None else peel_depth[:hp, :wp].contiguous()
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=rows.device)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=rows.device)
    attrs = torch.empty((N_CHANNELS + 1, hp, wp), dtype=torch.float32,
                        device=rows.device)
    keys, table = walk_scratch(rows, n_tiles, tile_h, tile_w, hp, wp,
                               "gbuf_tiles")
    err = kernels.library("gbuf_tiles").vkr_gbuf_tiles(
        rows.data_ptr(), seg_starts.data_ptr(), seg_counts.data_ptr(),
        None if peel is None else peel.data_ptr(),
        *((0, 0) if peel is None else peel.shape), tiles_x, tiles_y, tile_h,
        tile_w, int(row_offset), zbuf.data_ptr(), tid.data_ptr(),
        attrs.data_ptr(),
        keys.data_ptr(), table.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    kernels.check(err, "gbuf_tiles")
    kernels.LAUNCHES["gbuf_tiles"] += 1
    return zbuf, tid, attrs


def walk_scratch(rows, n_tiles: int, tile_h: int, tile_w: int, hp: int,
                 wp: int, what: str):
    """The CUDA walk's scratch on rows' device: one 64-bit merge key per
    pixel and the int32 work-item table (item starts, counter, a done count
    per 8x128 cell). The kernel cuts tiles into 8x128 cells and stages
    each row's raster fields as 16-byte pieces, so tiles must be whole
    cells and rows 16-byte aligned."""
    if tile_h % 8 or tile_w % 128:
        raise ValueError(f"{what}: the CUDA kernel takes tiles of 8k x 128k "
                         f"pixels, got {tile_h}x{tile_w}")
    if rows.data_ptr() % 16:
        raise ValueError(f"{what}: pair_rows must be 16-byte aligned")
    n_cells = tile_h // 8 * (tile_w // 128)
    return (torch.empty(hp * wp, dtype=torch.int64, device=rows.device),
            torch.empty(n_tiles * (1 + n_cells) + 2, dtype=torch.int32,
                        device=rows.device))


def walk_reference(rows, seg_starts, seg_counts, peel, *, tiles_x: int,
                   tile_h: int, tile_w: int, chunk_evals: int = 1 << 24,
                   row_offset: int = 0):
    """The in-order LESS_OR_EQUAL walk of every tile's pair segment, shared
    by the plain versions of K1 and K7. rows (n_pairs, 64); peel (hp*wp,)
    strict depth floor; row_offset: the band's first row in the full frame,
    added to the rows the planes are evaluated at. Returns (zbuf (hp*wp,), winning pair row per pixel
    (hp*wp,) int64, -1 = background).

    Instead of walking each segment in order, it uses what the in-order
    walk computes: the final depth is the minimum covering depth, and the
    winner is the LAST covering pair (in segment order) whose depth equals
    that minimum. Pair-pixel tests run in chunks of about chunk_evals: one
    pass takes the per-pixel minimum, a second the winner."""
    dev = rows.device
    wp = tiles_x * tile_w
    counts = seg_counts.long()
    n_tiles = counts.shape[0]
    tile_of = torch.repeat_interleave(
        torch.arange(n_tiles, device=dev), counts)   # walk order
    n_walk = tile_of.shape[0]
    first = torch.cumsum(counts, 0) - counts
    order = torch.arange(n_walk, device=dev)
    row_of = seg_starts.long()[tile_of] + (order - first[tile_of])
    ly = torch.arange(tile_h, device=dev).repeat_interleave(tile_w)
    lx = torch.arange(tile_w, device=dev).repeat(tile_h)
    # the rows the planes are evaluated at: the band's, in the full frame
    ly_frame = ly + row_offset
    step = max(1, chunk_evals // (tile_h * tile_w))

    def tests(lo, hi):
        t = tile_of[lo:hi, None]
        gx = (t % tiles_x) * tile_w + lx
        gy = (t // tiles_x) * tile_h + ly
        pix = gy * wp + gx
        px = gx.float() + 0.5
        py = ((t // tiles_x) * tile_h + ly_frame).float() + 0.5
        r = rows[row_of[lo:hi]]

        def row_plane(ka, kb, kc):
            return plane(r[:, ka:ka + 1], r[:, kb:kb + 1], r[:, kc:kc + 1],
                         px, py)

        d = row_plane(9, 10, 11)
        cover = ((row_plane(0, 3, 6) >= 0.0) & (row_plane(1, 4, 7) >= 0.0)
                 & (row_plane(2, 5, 8) >= 0.0) & (d >= 0.0) & (d <= 1.0)
                 & (d > peel[pix]))
        return pix, d, cover

    zbuf = torch.ones(peel.shape[0], dtype=torch.float32, device=dev)
    for lo in range(0, n_walk, step):
        pix, d, cover = tests(lo, lo + step)
        zbuf.scatter_reduce_(0, pix[cover], d[cover], reduce="amin")
    win = torch.full(peel.shape, -1, dtype=torch.long, device=dev)
    for lo in range(0, n_walk, step):
        pix, d, cover = tests(lo, lo + step)
        hit = cover & (d == zbuf[pix])
        walk = order[lo:lo + step, None].expand_as(pix)
        win.scatter_reduce_(0, pix[hit], walk[hit], reduce="amax")
    win_row = torch.where(win >= 0, row_of[win.clamp(min=0)] if n_walk
                          else win, -1)
    return zbuf, win_row


def gbuf_tiles_reference(pair_rows, seg_starts, seg_counts, peel_depth=None,
                         *, width: int, height: int, tile_h: int = 8,
                         tile_w: int = 128, chunk_evals: int = 1 << 24,
                         row_offset: int = 0):
    """Plain version of gbuf_tiles (same arguments and results, any
    device): walk_reference, then the winner's resolve planes per pixel."""
    rows = pair_rows.reshape(-1, ROW_WIDTH)
    dev = rows.device
    tiles_x, tiles_y, hp, wp = _tiles(width, height, tile_h, tile_w)
    peel = _peel_floor(peel_depth, hp, wp, dev).reshape(-1)
    zbuf, win = walk_reference(rows, seg_starts, seg_counts, peel,
                               tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w,
                               chunk_evals=chunk_evals, row_offset=row_offset)

    has = win >= 0
    wrow = rows[win.clamp(min=0)] if rows.shape[0] else torch.zeros(
        (win.shape[0], ROW_WIDTH), dtype=torch.float32, device=dev)
    background = constant(_BACKGROUND, dev)
    coef = torch.where(has[:, None], wrow[:, RESOLVE_BASE:_MATERIAL + 1],
                       background)
    tid = torch.where(has, wrow[:, _TRI_ID], -1.0).to(torch.int32)
    gy, gx = torch.meshgrid(torch.arange(row_offset, row_offset + hp,
                                         device=dev),
                            torch.arange(wp, device=dev), indexing="ij")
    px = gx.reshape(-1).float() + 0.5
    py = gy.reshape(-1).float() + 0.5
    denom = plane(coef[:, 0], coef[:, 1], coef[:, 2], px, py)
    inv = 1.0 / torch.where(denom.abs() < 1e-20, 1e-20, denom)
    chans = [plane(coef[:, 3 + 3 * ch], coef[:, 4 + 3 * ch],
                   coef[:, 5 + 3 * ch], px, py) * inv
             for ch in range(N_CHANNELS)]
    attrs = torch.stack(chans + [coef[:, -1]]).reshape(N_CHANNELS + 1, hp, wp)
    return zbuf.reshape(hp, wp), tid.reshape(hp, wp), attrs
