"""vkr_tpu_torch texture layer against vkr_tpu's (raster/texture.py): the
native-size packing's meta table and pairing decision, and the samplers
(trilinear, bilinear, nearest; uniform and native packings; REPEAT and
CLAMP), the quad-derivative LOD, the material pair and the alpha test.
Inputs come from numpy with fixed seeds; vkr_tpu runs eagerly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.raster import texture as jtex
from vkr_tpu.scene.scene import build_mip_pyramid
from vkr_tpu_torch.raster import texture as ttex

torch.set_num_threads(1)

# Both sides fetch the same texels and lerp them in float32 in the same
# order; 1e-6 covers a last-bit difference of a lerp at the unit scale.
ATOL = 1e-6
H, W = 64, 256

# A native set like a glTF scene's: square REPEAT textures, a CLAMP pair
# of 32x8 (a 64x16 image halved by tex_size=32), a 16x16 albedo without MR.
NATIVE_SHAPES = [(32, 32), (32, 32), (8, 32), (8, 32), (16, 16), (32, 32)]
NATIVE_WRAPS = [0, 0, 1, 1, 0, 0]
MAT_ALBEDO = np.array([0, 1, 2, 4, -1, -1], np.int32)
MAT_MR = np.array([5, 5, 3, -1, 5, -1], np.int32)


def _images(shapes, seed):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 4), np.uint8) for h, w in shapes]
    for im in imgs:  # some zero alpha, as a MASK texture has
        im[..., 3] = np.where(im[..., 3] < 60, 0, im[..., 3])
    return imgs


def _sets(mode, mat_albedo=MAT_ALBEDO, mat_mr=MAT_MR, wraps=NATIVE_WRAPS,
          pairs=True):
    """(vkr_tpu TextureArray, port TextureArray) of one texture set.
    pairs=False packs vkr_tpu's without the material tables: it then keeps
    the per-texture quad rows its sample_texture_array reads."""
    jmat = (mat_albedo, mat_mr) if pairs else (None, None)
    if mode == "native":
        imgs = _images(NATIVE_SHAPES, 1)
        return (jtex.pack_texture_array_native(imgs, wraps, *jmat),
                ttex.pack_texture_array_native(imgs, wraps, mat_albedo,
                                               mat_mr, "cpu"))
    imgs = np.stack(_images([(32, 32)] * len(wraps), 2))
    mips = build_mip_pyramid(imgs)
    return (jtex.pack_texture_array(mips, wraps, *jmat),
            ttex.pack_texture_array(mips, wraps, mat_albedo, mat_mr, "cpu"))


def _inputs(seed, n_levels, n_tex):
    """Per-pixel texture ids, uvs reaching past [0, 1] (wrap and clamp)
    and LODs past both ends of the chain."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_tex, (H, W)).astype(np.int32)
    uv = rng.uniform(-1.3, 2.4, (H, W, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, n_levels + 0.5, (H, W)).astype(np.float32)
    return idx, uv, lod


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_native_meta_equals_vkr_tpu():
    """meta [offset, w, h, wrap] per (texture, level), base_wh (each
    texture's level-0 row) and n_levels equal vkr_tpu's; levels past a
    chain repeat its 1x1 tail."""
    jt, tt = _sets("native")
    meta = np.stack([_np(tt.level_off), _np(tt.level_w), _np(tt.level_h),
                     np.repeat(_np(tt.wrap), tt.n_levels)], -1)
    np.testing.assert_array_equal(meta, np.asarray(jt.meta))
    np.testing.assert_array_equal(meta[::tt.n_levels, 1:3],
                                  np.asarray(jt.base_wh))
    assert tt.n_levels == jt.n_levels == 6
    assert tt.base_size is None
    # every texel offset the meta names holds vkr_tpu's texel
    np.testing.assert_array_equal(_np(tt.texels), np.asarray(jt.flat))


def test_odd_edges_pad_before_halving():
    """_mip_chain_native: a 5x3 image halves to 3x2, 2x1, 1x1 with its
    last row / column repeated, (sum + 2) // 4, as vkr_tpu's."""
    img = _images([(5, 3)], 3)[0]
    got = ttex._mip_chain_native(img)
    want = jtex._mip_chain_native(img, True)
    assert [m.shape[:2] for m in got] == [(5, 3), (3, 2), (2, 1), (1, 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode,mat_mr,wraps,paired", [
    ("native", MAT_MR, NATIVE_WRAPS, True),
    # a material pairing textures of different dims: no pairs at all
    ("native", np.array([5, 5, 0, -1, 5, -1], np.int32), NATIVE_WRAPS,
     False),
    # a material pairing textures of different wraps: no pairs at all
    ("native", MAT_MR, [0, 0, 1, 0, 0, 0], False),
    ("uniform", MAT_MR, NATIVE_WRAPS, True),
    ("uniform", np.array([5, 5, 0, -1, 5, -1], np.int32), NATIVE_WRAPS,
     False),
])
def test_pairing_decision(mode, mat_mr, wraps, paired):
    """TextureArray.paired is vkr_tpu's choice to pack albedo+MR pair rows
    (the only path that filters trilinearly): native mode needs every
    material's wraps and dims to agree, uniform mode its wraps."""
    jt, tt = _sets(mode, mat_mr=mat_mr, wraps=wraps)
    assert (jt.pair_quad is not None) == tt.paired == paired


@pytest.mark.parametrize("quality", ttex.QUALITIES)
@pytest.mark.parametrize("mode", ["uniform", "native"])
def test_sample_texture_array(mode, quality):
    jt, tt = _sets(mode, pairs=False)
    idx, uv, lod = _inputs(7, tt.n_levels, len(NATIVE_SHAPES))
    want = jtex.sample_texture_array(jt, jnp.asarray(idx), jnp.asarray(uv),
                                     jnp.asarray(lod), quality=quality)
    got = ttex.sample_texture_array(tt, torch.from_numpy(idx).long(),
                                    torch.from_numpy(uv),
                                    torch.from_numpy(lod), quality=quality)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    # both wraps and the clamped edges were sampled
    assert (uv < 0).any() and (uv > 1).any()


def test_sample_level_zero_without_lod():
    jt, tt = _sets("native", pairs=False)
    idx, uv, _ = _inputs(8, tt.n_levels, len(NATIVE_SHAPES))
    want = jtex.sample_texture_array(jt, jnp.asarray(idx), jnp.asarray(uv))
    got = ttex.sample_texture_array(tt, torch.from_numpy(idx).long(),
                                    torch.from_numpy(uv))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


def test_quad_derivative_lod_native():
    rng = np.random.default_rng(9)
    uv = np.cumsum(rng.uniform(0, 0.01, (H, W, 2)), axis=1).astype(
        np.float32)
    wh = rng.choice([8, 16, 32, 1024], (H, W, 2)).astype(np.int32)
    want = jtex.quad_derivative_lod_native(jnp.asarray(uv), jnp.asarray(wh))
    got = ttex.quad_derivative_lod_native(torch.from_numpy(uv),
                                          torch.from_numpy(wh))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("trilinear", [True, False])
@pytest.mark.parametrize("mode", ["uniform", "native"])
def test_sample_material_pair(mode, trilinear):
    """Both halves at one LOD, where the material has each texture (the
    caller masks the others)."""
    jt, tt = _sets(mode)
    rng = np.random.default_rng(10)
    mat = rng.integers(-1, len(MAT_ALBEDO), (H, W)).astype(np.int32)
    _, uv, lod = _inputs(11, tt.n_levels, 1)
    want = jtex.sample_material_pair(jt, jnp.asarray(mat), jnp.asarray(uv),
                                     jnp.asarray(lod), trilinear=trilinear)
    got = ttex.sample_material_pair(tt, torch.from_numpy(mat).long(),
                                    torch.from_numpy(uv),
                                    torch.from_numpy(lod),
                                    trilinear=trilinear)
    m = np.maximum(mat, 0)
    for half, tex_of in zip(range(2), (MAT_ALBEDO, MAT_MR)):
        has = (mat >= 0) & (tex_of[m] >= 0)
        assert has.mean() > 0.3
        np.testing.assert_allclose(_np(got[half])[has],
                                   np.asarray(want[half])[has],
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("branch", ["sparse", "dense"])
@pytest.mark.parametrize("mode", ["uniform", "native"])
def test_sample_alpha_matches_sparse(mode, branch):
    """The port's dense sample_alpha equals vkr_tpu's sample_alpha_sparse on
    its active pixels, in its sparse branch (active pixels in at most
    cap_frac of the (8, 128) tiles) and its dense branch (in more)."""
    jt, tt = _sets(mode)
    idx, uv, lod = _inputs(12, tt.n_levels, len(NATIVE_SHAPES))
    active = np.zeros((H, W), bool)
    if branch == "sparse":  # 3 of the 16 tiles
        active[3:6, 10:40] = True
        active[20, 200] = active[50, 5] = True
    else:
        active[np.random.default_rng(13).random((H, W)) < 0.3] = True
    tiles = active.reshape(H // 8, 8, W // 128, 128).any(axis=(1, 3))
    assert (tiles.mean() <= 0.25) == (branch == "sparse")
    want = jtex.sample_alpha_sparse(jt, jnp.asarray(idx), jnp.asarray(uv),
                                    jnp.asarray(lod), jnp.asarray(active))
    got = ttex.sample_alpha(tt, torch.from_numpy(idx).long(),
                            torch.from_numpy(uv), torch.from_numpy(lod))
    np.testing.assert_allclose(_np(got)[active], np.asarray(want)[active],
                               rtol=0, atol=ATOL)
    if branch == "dense":  # alpha-0 footprints were sampled
        assert (_np(got)[active] == 0).any()


def test_unknown_quality_raises():
    _, tt = _sets("native")
    idx, uv, lod = _inputs(14, tt.n_levels, 1)
    with pytest.raises(ValueError, match="quality"):
        ttex.sample_texture_array(tt, torch.from_numpy(idx).long(),
                                  torch.from_numpy(uv), torch.from_numpy(lod),
                                  quality="anisotropic")


def test_material_pair_needs_a_paired_set():
    """sample_material_pair shares one tap setup between a material's two
    textures, so it refuses a set whose pairs disagree (here in wrap)."""
    _, tt = _sets("native", wraps=[0, 0, 1, 0, 0, 0])
    assert not tt.paired
    mat = torch.zeros((H, W), dtype=torch.long)
    uv = torch.zeros((H, W, 2))
    with pytest.raises(ValueError, match="paired"):
        ttex.sample_material_pair(tt, mat, uv, torch.zeros((H, W)))
