"""vkr_tpu_torch raster layer against vkr_tpu: the SoA front end, K1's
plain version against the Pallas kernel in interpret mode, and the second
masked layer of the G-buffer pass. Inputs come from numpy with fixed
seeds. The whole G-buffer pass on the masked colonnade is held in
test_torch_raster_gbuffer.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.raster import gbuf_kernel as jgk
from vkr_tpu.raster import pair_rows as jrows
from vkr_tpu.raster import setup as jsetup
from vkr_tpu_torch.raster import gbuf_kernel as tgk
from vkr_tpu_torch.raster import pair_rows as trows
from vkr_tpu_torch.raster import setup as tsetup

# the G-buffer test's frame size (test_torch_raster_gbuffer.py)
W, H = 256, 128


def _triangles(seed, n, spread=0.3, near_cross=0.1):
    """Random clip-space triangles: (4, 3n) corner table + (9, 3n)
    attribute table + (n,) materials; some triangles cross the near
    plane."""
    rng = np.random.default_rng(seed)
    cen = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wv = (1 + 4 * rng.random((n, 1))).astype(np.float32)
    corners = []
    for _ in range(3):
        p = cen + spread * (rng.random((n, 3)).astype(np.float32) - 0.5)
        z = p[:, 2:3] * 0.5 + 0.5
        z = z - near_cross * (rng.random((n, 1)) < 0.2)
        corners.append(np.concatenate([p[:, :2] * wv, z * wv, wv], 1))
    clip_t = np.ascontiguousarray(np.concatenate(corners, 0).T, np.float32)
    attr_t = rng.random((9, 3 * n)).astype(np.float32)
    mat = rng.integers(0, 5, n).astype(np.int32)
    return clip_t, attr_t, mat


def _front_end_jax(clip_t, attr_t, mat, tile_w, cap, jitter):
    n = clip_t.shape[1] // 3
    tri2, wts, valid = jsetup.clip_near_corners_t(jnp.asarray(clip_t), n)
    cc = jsetup._corners_from_weights_t(tri2, wts)
    st = jsetup.triangle_setup_t(cc, valid, W, H, jnp.asarray(jitter))
    ptri, ss, sc, ov = jsetup.bin_triangles_t(st.bbox, st.valid, W, H, 8,
                                              tile_w, cap)
    ca = jrows.corner_attributes_pre_t(jnp.asarray(attr_t), wts, n)
    rows = jrows.expand_pair_rows(
        jrows.build_tri_rows_t(st, ca, jnp.asarray(np.concatenate([mat,
                                                                   mat]))),
        ptri)
    return [np.asarray(a) for a in (ptri, ss, sc, ov, rows)]


def _front_end_torch(clip_t, attr_t, mat, tile_w, cap, jitter):
    n = clip_t.shape[1] // 3
    tri2, wts, valid = tsetup.clip_near_corners_t(torch.from_numpy(clip_t), n)
    cc = tsetup.corners_from_weights_t(tri2, wts)
    st = tsetup.triangle_setup_t(cc, valid, W, H, torch.from_numpy(jitter))
    ptri, ss, sc, ov = tsetup.bin_triangles_t(st.bbox, st.valid, W, H, 8,
                                              tile_w, cap)
    ca = trows.corner_attributes_pre_t(torch.from_numpy(attr_t), wts, n)
    rows = trows.expand_pair_rows(
        trows.build_tri_rows_t(st, ca, torch.from_numpy(np.concatenate(
            [mat, mat]))), ptri)
    return [a.numpy() for a in (ptri, ss, sc, ov, rows)]


JITTER = np.asarray([0.3 / W, -0.2 / H], np.float32)


class TestFrontEnd:
    """Identical pair order, segment tables and overflow from identical
    corners. vkr_tpu runs eagerly here (op by op, no FMA contraction), so
    the float rows agree to the last bit as well."""

    @pytest.mark.parametrize("tile_w", [128, 512])
    def test_pairs_and_segments_identical(self, tile_w):
        clip_t, attr_t, mat = _triangles(11, 120)
        want = _front_end_jax(clip_t, attr_t, mat, tile_w, 4096, JITTER)
        got = _front_end_torch(clip_t, attr_t, mat, tile_w, 4096, JITTER)
        for name, g, w in zip(("pair_tri", "seg_starts", "seg_counts",
                               "overflow"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert int(got[3]) == 0 and got[2].sum() > 100
        n_live = int(got[2].sum())
        # (n_rows, 128) tail padding on vkr_tpu's side is a DMA device
        np.testing.assert_array_equal(got[4][:n_live],
                                      want[4].reshape(-1, 64)[:n_live])

    def test_forced_overflow_counted_identically(self):
        clip_t, attr_t, mat = _triangles(12, 120)
        cap = 64
        want = _front_end_jax(clip_t, attr_t, mat, 128, cap, JITTER)
        got = _front_end_torch(clip_t, attr_t, mat, 128, cap, JITTER)
        assert int(want[3]) > 0
        for name, g, w in zip(("pair_tri", "seg_starts", "seg_counts",
                               "overflow"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


class TestGbufKernelPlainVersion:
    """K1's plain version against vkr_tpu's Pallas kernel (interpret mode)
    on vkr_tpu's own pair buffer. Depth and triangle id must be equal; the
    attributes agree to 1e-5 (a few ulps of the plane evaluation: the
    Pallas interpreter may contract a*px + b*py + c differently)."""

    @pytest.mark.parametrize("tile_w,peel", [(128, False), (512, True)])
    def test_matches_interpret_kernel(self, tile_w, peel):
        clip_t, attr_t, mat = _triangles(21 + tile_w, 60)
        ptri, ss, sc, ov, rows = _front_end_jax(clip_t, attr_t, mat, tile_w,
                                                4096, JITTER)
        assert int(sc.sum()) > 50
        peel_np = None
        if peel:
            peel_np = (np.random.default_rng(3).random((H, W)) * 0.6
                       ).astype(np.float32)
        want = jgk.gbuf_tiles(
            jnp.asarray(rows), jnp.asarray(ss), jnp.asarray(sc),
            None if peel_np is None else jnp.asarray(peel_np), None,
            width=W, height=H, tile_h=8, tile_w=tile_w, interpret=True)
        want = [np.asarray(a) for a in want]
        got = tgk.gbuf_tiles(
            torch.from_numpy(rows.copy()), torch.from_numpy(ss.copy()),
            torch.from_numpy(sc.copy()),
            None if peel_np is None else torch.from_numpy(peel_np),
            width=W, height=H, tile_h=8, tile_w=tile_w)
        got = [a.numpy() for a in got]
        assert (got[1] >= 0).mean() > 0.01
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        from vkr_tpu_torch import kernels

        clip_t, attr_t, mat = _triangles(5, 40)
        _, ss, sc, _, rows = _front_end_torch(clip_t, attr_t, mat, 128,
                                              4096, JITTER)
        before = kernels.LAUNCHES["gbuf_tiles"]
        args = (torch.from_numpy(rows.copy()), torch.from_numpy(ss.copy()),
                torch.from_numpy(sc.copy()))
        a = tgk.gbuf_tiles(*args, width=W, height=H)
        b = tgk.gbuf_tiles_reference(*args, width=W, height=H,
                                     chunk_evals=5000)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert kernels.LAUNCHES["gbuf_tiles"] == before


def test_second_masked_layer_changes_the_centre():
    """tests/test_golden.py::TestMaskDepthPeel on the port: in the
    two-masked-quads scene at 64x64, mask_peel_layers=2 shows the back
    masked quad through the front quad's hole, so the centre 8x8 pixels
    change material and come nearer. Both layer counts equal vkr_tpu's
    oracle G-buffer (use_pallas=False, run eagerly as test_golden.py runs
    it) there, away from the edges where its oracle raster parts from its
    Pallas raster. With two layers some of those pixels still show the
    backdrop, on both sides and in vkr_tpu's Pallas path too; jitted, the
    oracle shows the back quad on all 64 (its contracted arithmetic), so
    the eager form is the one held."""
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import two_masked_quads_scene as j_scene
    from vkr_tpu_torch.mathlib.transforms import look_at, perspective
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.procedural import two_masked_quads_scene

    scene_np = two_masked_quads_scene()
    for name in scene_np._fields:
        a, b = getattr(scene_np, name), getattr(j_scene(), name)
        if name == "tex_mips":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
    view = look_at((0, 0, -4), (0, 0, 1), (0, -1, 0))
    vp = (perspective(np.radians(60), 1.0, 0.05, 80.0) @ view).astype(
        np.float32)
    scene = upload_scene(scene_np, "cpu")
    jscene = j_upload(scene_np)
    centre = (slice(28, 36), slice(28, 36))
    got = {}
    for layers in (1, 2):
        kw = dict(width=64, height=64, quantize=False,
                  mask_peel_layers=layers)
        g = render_gbuffer(scene, torch.from_numpy(vp), torch.from_numpy(vp),
                           torch.zeros(2), **kw)
        jg = j_render(jscene, jnp.asarray(vp), jnp.asarray(vp), jnp.zeros(2),
                      use_pallas=False, **kw)
        got[layers] = (g.material[centre][..., 2].numpy(),
                       g.depth[centre].numpy())
        np.testing.assert_array_equal(got[layers][0],
                                      np.asarray(jg.material)[centre][..., 2])
        np.testing.assert_array_equal(got[layers][1],
                                      np.asarray(jg.depth)[centre])
    (m1, d1), (m2, d2) = got[1], got[2]
    assert not np.allclose(m1, m2)
    assert (d2 <= d1 + 1e-6).all() and (d2 < d1 - 1e-6).any()
