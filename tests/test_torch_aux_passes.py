"""The port's utility passes (passes/util_passes.py) and fetch heatmap
(passes/trace_samples.py) against vkr_tpu's, on the same inputs made from
a seed with numpy. vkr_tpu's functions run as a caller of
registry.get(name) runs them: eagerly, op by op."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkr_tpu.passes.trace_samples as jts
import vkr_tpu.passes.util_passes as ju
from vkr_tpu_torch.passes import trace_samples as tts
from vkr_tpu_torch.passes import util_passes as tu

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

H, W = 64, 128
# Shares of hashed values that differ from vkr_tpu's (measured on this CPU
# at 64x128 and written here): fract(sin(x) * 43758.5453) multiplies sin's
# last ulp by 43,758, the port takes sin in float64 rounded once, and
# XLA's float32 sin is not correctly rounded (ROADMAP queue 3).
PERLIN_LATTICE_SHARE = 0.02   # measured 0.0112 of the lattice hashes
PERLIN_PIXEL_SHARE = 0.005    # measured 0.0020 of the pixels off by > 1e-3
ROTATIONS_SHARE = 0.02        # measured 0.0095-0.0133 of the pixels


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_perlin_lattice_hash_share():
    """The lattice hashes that perlin's eight octaves read at 64x128."""
    from vkr_tpu.passes.sampling import screen_uv_grid

    uv = np.asarray(screen_uv_grid(H, W))
    total = differ = 0
    for octave in range(ju._FIRST_OCTAVE, ju._FIRST_OCTAVE + ju._OCTAVES):
        coords = [np.floor(30.0 * uv[..., k] * 2.0 ** octave)
                  .astype(np.float32) for k in (0, 1)]
        want = np.asarray(ju._lattice_noise(*map(jnp.asarray, coords)))
        got = tu._lattice_noise(*map(torch.from_numpy, coords)).numpy()
        total += want.size
        differ += int((want != got).sum())
    print(f"perlin lattice hashes differing: {differ / total:.4%}")
    assert differ / total <= PERLIN_LATTICE_SHARE


def test_perlin_pixels():
    """A pixel sums 36 lattice hashes per octave under cosine blends: where
    a hash differs the pixel moves; held on the share off by > 1e-3."""
    want = np.asarray(ju.gen_perlin_noise2d(H, W))
    got = tu.gen_perlin_noise2d(H, W, device="cpu").numpy()
    assert got.shape == want.shape == (H, W) and np.isfinite(got).all()
    share = float((np.abs(got - want) > 1e-3).mean())
    print(f"perlin pixels off by > 1e-3: {share:.4%}")
    assert share <= PERLIN_PIXEL_SHARE
    # the bulk follows vkr_tpu (the remaining differences are float32 cos)
    assert np.median(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("angle", [0.3, 1.0, 2.5, -0.7])
def test_rotations_share(angle):
    """draw_directions hashes -(x cos a + y sin a): the share of differing
    stripes' values, and every value in [0, 1)."""
    want = np.asarray(ju.draw_directions(H, W, angle))
    got = tu.draw_directions(H, W, angle, device="cpu").numpy()
    assert got.shape == (H, W) and got.min() >= 0.0 and got.max() < 1.0
    share = float((np.abs(got - want) > 1e-5).mean())
    print(f"rotations({angle}) values differing: {share:.4%}")
    assert share <= ROTATIONS_SHARE


@pytest.mark.parametrize("shape", [(64, 128, 3), (37, 50), (16, 1, 2),
                                   (96, 80)])
def test_gen_mipmaps_exact(shape):
    """The 2x2 means sum their four texels in XLA's order (pairwise where
    an output row is a power of two long, (37, 50)'s 1x1 and (96, 80)'s
    levels; in order elsewhere): equal."""
    img = _img(shape, 1)
    want = ju.gen_mipmaps(jnp.asarray(img))
    got = tu.gen_mipmaps(torch.from_numpy(img))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clears_exact():
    want = np.asarray(ju.clear_color(5, 7, (0.25, 0.5, 1.0, 0.0)))
    got = tu.clear_color(5, 7, (0.25, 0.5, 1.0, 0.0), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tu.clear_depth(5, 7, 0.75, device="cpu").numpy(),
        np.asarray(ju.clear_depth(5, 7, 0.75)))


@pytest.mark.parametrize("dst", [(40, 70), (128, 256)])
def test_blit_image(dst):
    src = _img((H, W, 4), 2)
    want = np.asarray(ju.blit_image(jnp.asarray(src), *dst))
    got = tu.blit_image(torch.from_numpy(src), *dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", list(tu.DrawTex))
@pytest.mark.parametrize("channels", [1, 2, 4])
def test_backbuffer_draw(mode, channels):
    """All five channel-select modes on 1-, 2- and 4-channel textures (a
    mode past the last channel shows the last, as in vkr_tpu)."""
    tex = _img((H, W, channels), 3)
    if channels == 1:
        tex = tex[..., 0]
    want = np.asarray(ju.backbuffer_draw(jnp.asarray(tex), 48, 96,
                                         ju.DrawTex(int(mode))))
    got = tu.backbuffer_draw(torch.from_numpy(tex), 48, 96, mode).numpy()
    assert got.shape == want.shape == (48, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_samples_marker_exact():
    """Two traces of seeded (source, fetch) uv pairs, some fetches off
    screen (clipped to the edge), a window covering part of the sources:
    the int32 heatmap, its image and the clear equal vkr_tpu's."""
    rng = np.random.default_rng(4)
    window = (0.2, 0.3, 0.6, 0.7)
    jm = jts.SamplesMarker(H, W, window)
    tm = tts.SamplesMarker(H, W, window, device="cpu")
    for _ in range(2):
        src = rng.uniform(0, 1, (32, 48, 2)).astype(np.float32)
        fetch = rng.uniform(-0.2, 1.2, (32, 48, 2)).astype(np.float32)
        want = np.asarray(jm.trace(jnp.asarray(src), jnp.asarray(fetch)))
        got = tm.trace(torch.from_numpy(src), torch.from_numpy(fetch))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0 and want[0].sum() > 0  # clipped fetches count
    np.testing.assert_array_equal(tm.to_image().numpy(),
                                  np.asarray(jm.to_image()))
    tm.clear()
    assert int(tm.heatmap.abs().sum()) == 0


def test_samples_marker_default_window():
    """vkr_tpu's default window (gtao/main.comp:29-32) at 1080p's shape:
    sources at the screen centre count, others do not."""
    jm = jts.SamplesMarker(270, 480)
    tm = tts.SamplesMarker(270, 480, device="cpu")
    src = np.full((4, 4, 2), 0.5, np.float32)
    src[0] = 0.1
    fetch = np.random.default_rng(5).uniform(0, 1, (4, 4, 2)).astype(
        np.float32)
    want = np.asarray(jm.trace(jnp.asarray(src), jnp.asarray(fetch)))
    got = tm.trace(torch.from_numpy(src), torch.from_numpy(fetch)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 12
