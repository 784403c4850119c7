"""The schedules of the port's CUDA tile walk (K1/K7, csrc/gbuf_tiles.cu)
and SSR march (csrc/ssr_march.cu), transcribed to PyTorch and held against
the plain versions on the CPU. The kernels themselves build and run only on
the card (chip_smoke.py); these tests check the design contracts they rest
on:

- the 64-bit merge key: walking a segment in chunks, in any order, and
  merging per pixel by the minimum key gives walk_reference's depth and
  winner exactly, ties, +0.0/-0.0 and a peel floor included;
- the warp-patch reject: with its margin, in float32 as the kernel writes
  it, it never rejects a (pair, patch) that covers a pixel under plane();
- the work-item table and the ray order cover every item and every ray
  exactly once.

Inputs come from numpy with fixed seeds, at small sizes."""

import numpy as np
import pytest
import torch

from vkr_tpu_torch.raster import gbuf_kernel as gk
from vkr_tpu_torch.raster import setup as tsetup

torch.set_num_threads(1)

EMPTY = (1 << 63) - 1  # no covering pair (the kernel's all-ones, as int64)


def _setup_rows(xs, ys, zs, width, height):
    """Pair rows (n, 64) from screen-space corners (3, n) through the
    port's triangle setup (fill-rule biased c, depth plane)."""
    n = xs.shape[1]
    corners = [[torch.tensor(v, dtype=torch.float32) for v in (
        xs[c] * 2.0 / width - 1.0, ys[c] * 2.0 / height - 1.0, zs[c],
        np.ones(n))] for c in range(3)]
    st = tsetup.triangle_setup_t(corners, torch.ones(n, dtype=torch.bool),
                                 width, height)
    rows = torch.zeros((n, 64), dtype=torch.float32)
    for i, v in enumerate(list(st.a) + list(st.b) + list(st.c)
                          + list(st.zplane)):
        rows[:, i] = v
    rows[:, 12] = torch.arange(n, dtype=torch.float32)
    return rows


# ---------------------------------------------------------------- (a) key

TILE_H, TILE_W, TILES_X, TILES_Y = 4, 8, 3, 2


def _tie_segments(seed):
    """Rows of large triangles with depths drawn to tie: constant planes
    0.25 / 0.5, planes of +0.0 and of -0.0 (all three coefficients -0.0:
    d evaluates to -0.0), and random planes; segments of 0-40 pairs."""
    rng = np.random.default_rng(seed)
    w, h = TILES_X * TILE_W, TILES_Y * TILE_H
    counts = rng.integers(0, 41, TILES_X * TILES_Y)
    counts[0] = 40
    n = int(counts.sum())
    xs = rng.integers(-6, w + 6, (3, n)) + 0.5
    ys = rng.integers(-6, h + 6, (3, n)) + 0.5
    rows = _setup_rows(xs, ys, rng.uniform(0.1, 0.9, (3, n)), w, h)
    kind = rng.integers(0, 5, n)
    for k, z in ((0, 0.25), (1, 0.5), (2, 0.0), (3, -0.0)):
        sel = torch.as_tensor(kind == k)
        rows[sel, 9:11] = float(np.copysign(0.0, z))
        rows[sel, 11] = z
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (rows, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(counts, dtype=torch.int32))


def _pixels():
    """(n_tiles, tile_px) pixel index and centre of every tile pixel."""
    wp = TILES_X * TILE_W
    t = torch.arange(TILES_X * TILES_Y)[:, None]
    ly = torch.arange(TILE_H).repeat_interleave(TILE_W)
    lx = torch.arange(TILE_W).repeat(TILE_H)
    gx = (t % TILES_X) * TILE_W + lx
    gy = (t // TILES_X) * TILE_H + ly
    return gy * wp + gx, gx.float() + 0.5, gy.float() + 0.5


def _walk_in_order(rows, row_ids, px, py, floor):
    """The kernel's walk of one item: its pairs in order, per pixel
    d <= z (the last covering pair among equal depths wins)."""
    z = torch.ones_like(px)
    win = torch.full(px.shape, -1, dtype=torch.int64)
    for row in row_ids:
        r = rows[row]
        e = [gk.plane(r[i], r[3 + i], r[6 + i], px, py) for i in range(3)]
        d = gk.plane(r[9], r[10], r[11], px, py)
        hit = ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (d >= 0) & (d <= 1)
               & (d <= z) & (d > floor))
        z = torch.where(hit, d, z)
        win = torch.where(hit, row, win)
    return z, win


def _key(z, win):
    """(canonical depth bits << 32) | (0xFFFFFFFF - row); -0.0 -> +0.0."""
    bits = torch.where(z == 0.0, 0, z.view(torch.int32).long())
    return torch.where(win >= 0, (bits << 32) | (0xFFFFFFFF - win), EMPTY)


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("with_peel", [False, True])
def test_merge_key_matches_walk_reference(chunk, with_peel):
    rows, starts, counts = _tie_segments(11 + chunk)
    pix, px, py = _pixels()
    n_px = TILES_X * TILES_Y * TILE_H * TILE_W
    rng = np.random.default_rng(chunk)
    peel = torch.full((n_px,), -1.0)
    if with_peel:
        peel = torch.tensor(rng.choice([-1.0, 0.0, 0.25, 0.5, 0.6], n_px),
                            dtype=torch.float32)
    items = [(t, c) for t in range(counts.numel())
             for c in range(0, int(counts[t]), chunk)]
    keys = torch.full((n_px,), EMPTY, dtype=torch.int64)
    for i in rng.permutation(len(items)):
        t, c = items[i]
        s, n = int(starts[t]), int(counts[t])
        z, win = _walk_in_order(rows, range(s + c, s + min(c + chunk, n)),
                                px[t], py[t], peel[pix[t]])
        keys.scatter_reduce_(0, pix[t], _key(z, win), reduce="amin")

    want_z, want_win = gk.walk_reference(rows, starts, counts, peel,
                                         tiles_x=TILES_X, tile_h=TILE_H,
                                         tile_w=TILE_W, chunk_evals=512)
    win = torch.where(keys == EMPTY, -1, 0xFFFFFFFF - (keys & 0xFFFFFFFF))
    assert torch.equal(win, want_win)
    # zbuf from the winner's own plane: the in-order walk's bits, -0.0 kept
    gx, gy = pix % (TILES_X * TILE_W), pix // (TILES_X * TILE_W)
    z = torch.ones(n_px)
    flat_px = torch.zeros(n_px)
    flat_py = torch.zeros(n_px)
    flat_px[pix.reshape(-1)] = gx.reshape(-1).float() + 0.5
    flat_py[pix.reshape(-1)] = gy.reshape(-1).float() + 0.5
    has = win >= 0
    r = rows[win[has]]
    z[has] = gk.plane(r[:, 9], r[:, 10], r[:, 11], flat_px[has], flat_py[has])
    assert torch.equal(z, want_z)
    seq_z = torch.ones(n_px)
    for t in range(counts.numel()):
        s, n = int(starts[t]), int(counts[t])
        seq_z[pix[t]] = _walk_in_order(rows, range(s, s + n), px[t], py[t],
                                       peel[pix[t]])[0]
    assert torch.equal(z.view(torch.int32), seq_z.view(torch.int32))
    assert bool((has & (z == 0) & torch.signbit(z)).any())  # -0.0 wins
    assert bool((has & (z == 0) & ~torch.signbit(z)).any())  # +0.0 wins
    assert has.float().mean() > 0.3


# ------------------------------------------------------------- (b) reject

PATCH_H, PATCH_W = 8, 16
RW, RH = 128, 32


def edge_rejects(a, b, c, x0, x1, y0, y1):
    """The kernel's edge_rejects in float32: e at the patch corner that
    maximises it, against -((|a| x1 + |b| y1) + |c|) 2^-20 - 2^-100."""
    e = gk.plane(a, b, c, torch.where(a > 0, x1, x0),
                 torch.where(b > 0, y1, y0))
    m = ((a.abs() * x1 + b.abs() * y1) + c.abs()) * 2.0 ** -20 + 2.0 ** -100
    return e < -m


def _reject_rows(kind, seed):
    rng = np.random.default_rng(seed)
    n = 400
    if kind == "front_end":
        # rows of random clip-space triangles through the front end: near
        # clip, corner weights and setup (fill-rule biased c)
        cen = rng.uniform(-1, 1, (n, 3))
        wv = 1 + 4 * rng.random((n, 1))
        corners = []
        for _ in range(3):
            p = cen + 0.2 * (rng.random((n, 3)) - 0.5)
            z = p[:, 2:3] * 0.5 + 0.5 - 0.2 * (rng.random((n, 1)) < 0.2)
            corners.append(np.concatenate([p[:, :2] * wv, z * wv, wv], 1))
        clip_t = torch.tensor(np.concatenate(corners, 0).T, dtype=torch.float32)
        tri2, wts, valid = tsetup.clip_near_corners_t(clip_t, n)
        cc = tsetup.corners_from_weights_t(tri2, wts)
        st = tsetup.triangle_setup_t(cc, valid, RW, RH)
        return torch.stack(list(st.a) + list(st.b) + list(st.c), 1)
    if kind == "pixel_centres":  # corners on pixel centres: e = 0 there
        xs = rng.integers(-4, RW + 4, (3, n)) + 0.5
        ys = rng.integers(-4, RH + 4, (3, n)) + 0.5
        ys[1, : n // 2] = ys[0, : n // 2]  # horizontal edges
        xs[2, n // 2:] = xs[0, n // 2:]    # vertical edges
    elif kind == "slivers":  # long, under a pixel wide
        x0 = rng.uniform(-10, RW + 10, n)
        y0 = rng.uniform(-4, RH + 4, n)
        ang = rng.uniform(0, 2 * np.pi, n)
        ln = rng.uniform(10, 80, n)
        wd = rng.uniform(1e-4, 0.6, n)
        xs = np.stack([x0, x0 + ln * np.cos(ang),
                       x0 + 0.5 * ln * np.cos(ang) - wd * np.sin(ang)])
        ys = np.stack([y0, y0 + ln * np.sin(ang),
                       y0 + 0.5 * ln * np.sin(ang) + wd * np.cos(ang)])
    else:  # small triangles anywhere, sub-pixel to a few pixels
        cx = rng.uniform(0, RW, n)
        cy = rng.uniform(0, RH, n)
        s = rng.uniform(0.05, 6.0, n)
        xs = cx + s * rng.uniform(-1, 1, (3, n))
        ys = cy + s * rng.uniform(-1, 1, (3, n))
    rows = _setup_rows(xs, ys, np.full((3, n), 0.5), RW, RH)
    return rows[:, :9]


@pytest.mark.parametrize("kind", ["front_end", "pixel_centres", "slivers",
                                  "small"])
def test_patch_reject_is_conservative(kind):
    r = _reject_rows(kind, {"front_end": 1, "pixel_centres": 2,
                            "slivers": 3, "small": 4}[kind])
    gy, gx = torch.meshgrid(torch.arange(RH), torch.arange(RW),
                            indexing="ij")
    px, py = gx.reshape(-1).float() + 0.5, gy.reshape(-1).float() + 0.5
    cover = torch.ones((r.shape[0], RH * RW), dtype=torch.bool)
    for i in range(3):
        cover &= gk.plane(r[:, i:i + 1], r[:, 3 + i:4 + i], r[:, 6 + i:7 + i],
                          px, py) >= 0.0
    # (pair, patch): any covered pixel of the 8x16 patch
    covered = cover.reshape(-1, RH // PATCH_H, PATCH_H, RW // PATCH_W,
                            PATCH_W).any(4).any(2)
    ys0 = torch.arange(0, RH, PATCH_H).float()[:, None] + 0.5
    xs0 = torch.arange(0, RW, PATCH_W).float()[None, :] + 0.5
    x0, y0 = xs0.expand(RH // PATCH_H, -1), ys0.expand(-1, RW // PATCH_W)
    x1, y1 = x0 + (PATCH_W - 1), y0 + (PATCH_H - 1)
    rejected = torch.zeros_like(covered)
    for i in range(3):
        rejected |= edge_rejects(r[:, i, None, None], r[:, 3 + i, None, None],
                                 r[:, 6 + i, None, None], x0, x1, y0, y1)
    assert not bool((covered & rejected).any())
    assert int(covered.sum()) > 50
    # the reject is not vacuous: it drops most patches a pair misses
    assert float(rejected[~covered].float().mean()) > 0.5


def test_reject_margin_covers_rounding_near_zero():
    """Edges whose exact value at a patch corner is within a few ulps of
    zero: the kernel's float32 corner value may round below zero while a
    pixel's plane() value rounds to >= 0. The margin keeps such pairs."""
    rng = np.random.default_rng(5)
    n = 20000
    a = torch.tensor(rng.uniform(-50, 50, n), dtype=torch.float32)
    b = torch.tensor(rng.uniform(-50, 50, n), dtype=torch.float32)
    xc = torch.tensor(rng.integers(0, 2000, n) + 0.5, dtype=torch.float32)
    yc = torch.tensor(rng.integers(0, 1000, n) + 0.5, dtype=torch.float32)
    # c puts the edge through the pixel centre (xc, yc), then a few ulps off
    c = -gk.plane(a, b, torch.zeros_like(a), xc, yc)
    c = c + torch.tensor(rng.integers(-3, 4, n), dtype=torch.float32) \
        * torch.finfo(torch.float32).eps * c.abs()
    covers = gk.plane(a, b, c, xc, yc) >= 0
    # the pixel is the patch's maximising corner
    x0 = torch.where(a > 0, xc - (PATCH_W - 1), xc)
    y0 = torch.where(b > 0, yc - (PATCH_H - 1), yc)
    rej = edge_rejects(a, b, c, x0, x0 + (PATCH_W - 1), y0,
                       y0 + (PATCH_H - 1))
    assert int(covers.sum()) > 1000
    assert not bool((covers & rej).any())


# ----------------------------------------------------- (c) item table, rays

@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (8, 512), (16, 256)])
def test_item_table_covers_every_chunk_once(tile_h, tile_w):
    """prep_kernel's scan and the walk's decode (binary search for the
    last tile whose first item <= item, then chunk and cell) visit every
    (tile, chunk, cell) exactly once, an empty segment as one chunk."""
    chunk = 128
    rng = np.random.default_rng(tile_w)
    counts = rng.integers(0, 600, 37)
    counts[::5] = 0
    cells = tile_h // 8 * (tile_w // 128)
    chunks = np.maximum(1, -(-counts // chunk))
    start = np.concatenate([[0], np.cumsum(chunks * cells)])
    seen = []
    for item in range(int(start[-1])):
        tile = int(np.searchsorted(start[:-1], item, side="right")) - 1
        local = item - start[tile]
        seen.append((tile, local // cells, local % cells))
    want = [(t, k, c) for t in range(len(counts)) for k in range(chunks[t])
            for c in range(cells)]
    assert sorted(seen) == want


@pytest.mark.parametrize("ray_h,ray_w", [(540, 960), (7, 13)])
def test_march_ray_order_covers_every_ray_once(ray_h, ray_w):
    """The march's warps take 8x4 patches of the ray grid, row-major, lane
    q of patch p marching ray (x, y) = (8 (p % patches_x) + q % 8,
    4 (p // patches_x) + q // 8); lanes past the grid's edge idle."""
    pw, ph = 8, 4
    patches_x = -(-ray_w // pw)
    n_lanes = patches_x * -(-ray_h // ph) * pw * ph
    s = np.arange(n_lanes)
    patch, q = s // (pw * ph), s % (pw * ph)
    x = (patch % patches_x) * pw + q % pw
    y = patch // patches_x * ph + q // pw
    live = (x < ray_w) & (y < ray_h)
    rays = (y * ray_w + x)[live]
    assert np.array_equal(np.sort(rays), np.arange(ray_h * ray_w))
    # a warp's 32 rays lie in one 8x4 patch
    assert (np.ptp(x[:32]) <= pw - 1) and (np.ptp(y[:32]) <= ph - 1)


def test_walk_scratch_checks_tiles_and_alignment():
    rows = torch.zeros((4, 64))
    keys, table = gk.walk_scratch(rows, 6, 8, 256, 16, 768, "t")
    assert keys.shape == (16 * 768,) and keys.dtype == torch.int64
    assert table.shape == (6 * (1 + 2) + 2,)
    with pytest.raises(ValueError, match="8k x 128k"):
        gk.walk_scratch(rows, 6, 8, 64, 16, 384, "t")
    with pytest.raises(ValueError, match="aligned"):
        gk.walk_scratch(rows.reshape(-1)[1:65].reshape(1, 64), 1, 8, 128, 8,
                        128, "t")
