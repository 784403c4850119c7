"""The port's shadow-map path against vkr_tpu's: K7's plain version against
vkr_tpu's Pallas kernel (interpret mode) on the same pair rows, the
visibility raster and the shadow map of the colonnade from the shading
light, and the shadow-factor lookup. Inputs come from numpy with fixed
seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.raster import kernel as jkernel
from vkr_tpu.raster import pair_rows as jrows
from vkr_tpu.raster import setup as jsetup
from vkr_tpu_torch.raster import kernel as tkernel

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

SIZE = 128


def _soup(seed, n_tri, z_range=(0.05, 0.95)):
    """Random clip-space triangles (tests/test_raster.py's soup)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.2, 1.2, (n_tri, 1, 2))
    offs = rng.uniform(-0.4, 0.4, (n_tri, 3, 2))
    z = rng.uniform(*z_range, (n_tri, 3, 1)).astype(np.float32)
    v = np.concatenate([center + offs, z, np.ones((n_tri, 3, 1))],
                       axis=-1).astype(np.float32)
    return v.reshape(-1, 4), np.arange(3 * n_tri,
                                       dtype=np.int32).reshape(n_tri, 3)


def _jax_pair_rows(clip, idx, width, height):
    """vkr_tpu's visibility-only front end (pipeline.py:142-202)."""
    corners, _, _, valid = jsetup.clip_near_triangles(jnp.asarray(clip),
                                                      jnp.asarray(idx))
    st = jsetup.triangle_setup(corners, valid, width, height)
    ptri, ss, sc, ov = jsetup.bin_triangles(st, width, height, 8, 128, 4096)
    rows = jrows.expand_pair_rows(jrows.build_tri_rows(st), ptri)
    assert int(ov) == 0
    return rows, ss, sc


class TestRasterTilesPlainVersion:
    def test_matches_interpret_kernel(self):
        """K7's plain version on vkr_tpu's own pair buffer against vkr_tpu's
        Pallas kernel in interpret mode: the same fma-form planes and the
        same in-order d <= z walk, so depth and triangle id are equal."""
        clip, idx = _soup(5, 60)
        rows, ss, sc = _jax_pair_rows(clip, idx, 256, 64)
        want = [np.asarray(a) for a in jkernel.rasterize_tiles(
            rows, ss, sc, width=256, height=64, interpret=True)]
        got = [a.numpy() for a in tkernel.rasterize_tiles_reference(
            torch.from_numpy(np.array(rows)), torch.from_numpy(np.array(ss)),
            torch.from_numpy(np.array(sc)), width=256, height=64)]
        assert (got[1] >= 0).mean() > 0.2
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    def test_wrapper_takes_plain_version_on_cpu(self):
        from vkr_tpu_torch import kernels

        clip, idx = _soup(6, 30)
        rows, ss, sc = (torch.from_numpy(np.array(a)) for a in
                        _jax_pair_rows(clip, idx, 256, 64))
        before = kernels.LAUNCHES["rasterize_tiles"]
        a = tkernel.rasterize_tiles(rows, ss, sc, width=256, height=64)
        b = tkernel.rasterize_tiles_reference(rows, ss, sc, width=256,
                                              height=64, chunk_evals=3000)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert kernels.LAUNCHES["rasterize_tiles"] == before

    def test_visibility_only_refuses_peel(self):
        from vkr_tpu_torch.raster.pipeline import rasterize

        clip, _ = _soup(7, 4)
        corners_t = torch.from_numpy(np.ascontiguousarray(
            clip.reshape(-1, 3, 4).transpose(2, 1, 0).reshape(4, -1)))
        with pytest.raises(ValueError, match="peel_depth"):
            rasterize(corners_t, width=64, height=64,
                      peel_depth=torch.zeros((64, 64)))


def _light_mvp():
    """A point light at shading's LIGHT_POS looking straight down over the
    hall (90 degrees, near 0.5, far 40)."""
    from vkr_tpu_torch.mathlib.transforms import look_at, perspective
    from vkr_tpu_torch.passes.shading import LIGHT_POS

    eye = np.asarray(LIGHT_POS, np.float32)
    view = look_at(eye, eye - np.asarray([0.0, 1.0, 0.0], np.float32),
                   (0.0, 0.0, 1.0))
    return (perspective(np.radians(90.0), 1.0, 0.5, 40.0) @ view).astype(
        np.float32)


@pytest.fixture(scope="module")
def hall():
    """The 24-column colonnade (tessellation 4) for both packages, and the
    light's view-projection."""
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy

    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    return j_upload(scene_np), scene_from_numpy(scene_np, "cpu"), _light_mvp()


def test_shadow_visibility_matches_oracle(hall):
    """The port's visibility raster of the whole scene (K7's path) against
    vkr_tpu's rasterize(use_pallas=False) on its generic front end, ids in
    vkr_tpu's concatenate([tri_opaque, tri_masked]) order. The port's
    corner transform is one matmul on world corners, vkr_tpu's two on
    vertices: an ulp apart, which may flip a knife-edge pixel. Triangle
    ids agree on >= 99.9% of the texels and depth is equal (up to 1e-6)
    where they agree."""
    from vkr_tpu.raster import rasterize as j_rasterize
    from vkr_tpu.raster import transform_vertices
    from vkr_tpu_torch.passes.shadows import scene_corners
    from vkr_tpu_torch.raster.pipeline import rasterize
    from vkr_tpu_torch.raster.setup import corner_transform_t

    jscene, scene, mvp = hall
    clip = transform_vertices(jscene.positions, jscene.vert_transform,
                              jscene.transforms, jnp.asarray(mvp))
    idx = jnp.concatenate([jscene.tri_opaque, jscene.tri_masked], axis=0)
    want = j_rasterize(clip, idx, width=SIZE, height=SIZE, use_pallas=False)
    got = rasterize(corner_transform_t(scene_corners(scene),
                                       torch.from_numpy(mvp)),
                    width=SIZE, height=SIZE)
    assert got.resolved is None and int(got.overflow) == 0
    tid_w, tid_g = np.asarray(want.tri_id), got.tri_id.numpy()
    assert (tid_g >= 0).mean() > 0.5
    same = tid_w == tid_g
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got.depth.numpy()[same],
                               np.asarray(want.depth)[same], rtol=0,
                               atol=1e-6)


def test_render_shadow_map(hall):
    """render_shadow_map against vkr_tpu's (use_pallas=False): the depth
    of the same visibility raster, so equal to 1e-6 on >= 99.9% of the
    texels."""
    from vkr_tpu.passes.shadows import render_shadow_map as j_shadow
    from vkr_tpu_torch.passes.shadows import render_shadow_map

    jscene, scene, mvp = hall
    want = np.asarray(j_shadow(jscene, jnp.asarray(mvp), size=SIZE,
                               use_pallas=False))
    got = render_shadow_map(scene, torch.from_numpy(mvp), size=SIZE).numpy()
    assert got.shape == (SIZE, SIZE) and np.isfinite(got).all()
    assert (got < 1.0).mean() > 0.5
    assert (np.abs(got - want) <= 1e-6).mean() >= 0.999


def test_sample_shadow_factor(hall):
    """The nearest-tap depth compare on random world points over the hall
    floor and in the air, with one shadow map for both: the same
    projection and compare, equal on >= 99.9% of the points (a point
    within an ulp of its texel's edge or of the bias may flip)."""
    from vkr_tpu.passes.shadows import sample_shadow_factor as j_factor
    from vkr_tpu_torch.passes.shadows import (render_shadow_map,
                                              sample_shadow_factor)

    _, scene, mvp = hall
    shadow_map = render_shadow_map(scene, torch.from_numpy(mvp), size=SIZE)
    rng = np.random.default_rng(11)
    pts = np.stack([rng.uniform(-12, 8, (64, 64)), rng.uniform(0, 4, (64, 64)),
                    rng.uniform(-6, 6, (64, 64))], -1).astype(np.float32)
    want = np.asarray(j_factor(jnp.asarray(pts), jnp.asarray(mvp),
                               jnp.asarray(shadow_map.numpy())))
    got = sample_shadow_factor(torch.from_numpy(pts), torch.from_numpy(mvp),
                               shadow_map).numpy()
    assert 0.01 < (got == 0.0).mean() < 0.99
    assert (got == want).mean() >= 0.999
