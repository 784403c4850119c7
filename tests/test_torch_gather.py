"""The plain versions of K4/K5/K6 (vkr_tpu_torch/raster/gather_kernel.py)
against vkr_tpu's Pallas window-gather kernels in interpret mode. A small
radius and few offset sets keep the interpret compiles short; offsets run
past +-radius and off the image edges to hit every clamp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.raster import gather_kernel as jgk
from vkr_tpu_torch import kernels
from vkr_tpu_torch.raster import gather_kernel as tgk

R = 4
H, W = 21, 200  # not tile-aligned: exercises vkr_tpu's edge padding

# vkr_tpu rounds the row fraction through a window-local coordinate
# (row + radius + off, < 16 here), the port through off - floor(off):
# up to an ulp of 16 (1.9e-6) in the weight, times a tap difference <= 1.
ATOL = 1e-5


def _offsets(seed, shape):
    rng = np.random.default_rng(seed)
    # +-(R + 3) px: well past the clamp radius; near the borders the taps
    # land off the image and clamp to its edge
    return (rng.uniform(-R - 3, R + 3, shape).astype(np.float32),
            rng.uniform(-R - 3, R + 3, shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("channels", [1, 2])
def test_window_gather_matches_pallas(channels):
    rng = np.random.default_rng(channels)
    shape = (H, W) if channels == 1 else (H, W, channels)
    img = rng.random(shape).astype(np.float32)
    off_y, off_x = _offsets(10 + channels, (H, W))
    want = np.asarray(jgk.window_gather_bilinear(
        jnp.asarray(img), jnp.asarray(off_y), jnp.asarray(off_x), radius=R,
        interpret=True))
    got = tgk.window_gather_bilinear(_t(img), _t(off_y), _t(off_x),
                                     radius=R).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_window_gather_multi_matches_pallas():
    img = np.random.default_rng(3).random((H, W)).astype(np.float32)
    off_y, off_x = _offsets(4, (3, H, W))
    want = np.asarray(jgk.window_gather_bilinear_multi(
        jnp.asarray(img), jnp.asarray(off_y), jnp.asarray(off_x), radius=R,
        interpret=True))
    got = tgk.window_gather_bilinear_multi(_t(img), _t(off_y), _t(off_x),
                                           radius=R).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_taa_history_gather_matches_pallas():
    h, w = 16, 128
    rng = np.random.default_rng(5)
    color = rng.random((h, w, 3)).astype(np.float32)
    depth = rng.random((h, w)).astype(np.float32)
    off_y, off_x = _offsets(6, (h, w))
    hist, taps, pdepth = jgk.taa_history_gather(
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(off_y),
        jnp.asarray(off_x), radius=R, interpret=True)
    want = np.concatenate(
        [np.moveaxis(np.asarray(t), -1, 0) for t in [hist] + list(taps)]
        + [np.asarray(pdepth)[None]])
    got = tgk.taa_history_gather(_t(color), _t(depth), _t(off_y), _t(off_x),
                                 radius=R).numpy()
    assert got.shape == (16, h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_taa_history_gather_equals_six_window_gathers():
    """K6 must equal six K5 calls with (off_y + dy, off_x + dx), each tap
    clamped on its own (the same arithmetic, so exactly)."""
    h, w = 24, 40
    rng = np.random.default_rng(7)
    color = _t(rng.random((h, w, 3)).astype(np.float32))
    depth = _t(rng.random((h, w)).astype(np.float32))
    oy, ox = (_t(a) for a in _offsets(8, (h, w)))
    got = tgk.taa_history_gather(color, depth, oy, ox, radius=R)
    planes = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1)):
        tap = tgk.window_gather_bilinear(color, oy + dy, ox + dx, radius=R)
        planes.extend(tap[..., c] for c in range(3))
    planes.append(tgk.window_gather_bilinear(depth, oy, ox, radius=R))
    torch.testing.assert_close(got, torch.stack(planes), rtol=0, atol=1e-6)


def test_zero_offset_is_identity_and_cpu_does_not_count():
    img = _t(np.random.default_rng(9).random((8, 12, 3)).astype(np.float32))
    zero = torch.zeros(8, 12)
    before = sum(kernels.LAUNCHES.values())
    torch.testing.assert_close(
        tgk.window_gather_bilinear(img, zero, zero, radius=R), img,
        rtol=0, atol=0)
    assert sum(kernels.LAUNCHES.values()) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    img = torch.zeros(8, 12)
    with pytest.raises(ValueError):
        tgk._check("k", (img, torch.zeros(8, 11)), ((8, 12), (8, 12)))
    with pytest.raises(ValueError):
        tgk._check("k", (img.double(),), ((8, 12),))
    with pytest.raises(ValueError):
        tgk._check("k", (img.t(),), ((12, 8),))


# K5's launch (csrc/window_gather.cu, window_gather_k5 and k5_grid):
# blocks of kK5ThreadsX x kK5Rows threads, one pixel per thread; a warp is
# the 32 threads of one block row.
K5_THREADS_X, K5_ROWS = 32, 8


def _k5_walk(h, w, ch):
    """window_gather_k5's index walk in PyTorch: per pixel, the offset
    reads; per output element, the writes; and per warp (block, row of
    the block), its 32 lanes' pixel indices and which lanes are live."""
    grid_x = -(-w // K5_THREADS_X)
    grid_y = -(-h // K5_ROWS)
    bx, by, ty, tx = torch.meshgrid(
        torch.arange(grid_x), torch.arange(grid_y), torch.arange(K5_ROWS),
        torch.arange(K5_THREADS_X), indexing="ij")
    x = bx * K5_THREADS_X + tx
    y = by * K5_ROWS + ty
    live = (x < w) & (y < h)
    p = y * w + x
    reads = torch.zeros(h * w, dtype=torch.int64).index_add_(
        0, p[live], torch.ones_like(p[live]))
    el = (p[..., None] * ch + torch.arange(ch))[live].flatten()
    writes = torch.zeros(h * w * ch, dtype=torch.int64).index_add_(
        0, el, torch.ones_like(el))
    return (reads, writes, p.reshape(-1, K5_THREADS_X),
            live.reshape(-1, K5_THREADS_X))


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_k5_walk_covers_each_pixel_once(channels):
    """A 957-wide image (not a multiple of the block's 32 columns) and 9
    rows (not a multiple of 8): every pixel's offsets are read once and
    every output element written once, with ragged blocks at both edges."""
    reads, writes, _, live = _k5_walk(9, 957, channels)
    assert reads.eq(1).all() and writes.eq(1).all()
    assert (~live).any()


def test_k5_warps_hold_adjacent_pixels_of_one_row():
    """Each warp's live lanes are a run of adjacent pixels of one row, so
    its loads and stores coalesce; at the frame's half-res size (540, 960)
    every warp with a live lane is full."""
    lanes = torch.arange(K5_THREADS_X)
    for h, w in ((9, 957), (540, 960)):
        _, _, p, live = _k5_walk(h, w, 1)
        first = p[:, :1]
        assert (p - first)[live].eq(lanes.expand_as(p)[live]).all()
        assert (p // w)[live].eq(first.expand_as(p)[live] // w).all()
        # the live lanes are a prefix of the warp
        assert torch.equal(live, live.cumprod(1).bool())
    per_warp = live.sum(1)
    assert ((per_warp == 0) | (per_warp == K5_THREADS_X)).all()
