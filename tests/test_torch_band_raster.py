"""Band viewports (the multi-device frame's row bands) of the port's
raster and of its kernels' plain versions: K7 and K1 (through the band
front end), the oracle G-buffer, and K4/K5/K6 and the sampling helpers with
row0, against vkr_tpu's band form and against the rows of the port's own
whole-frame call.

The port's band rows must equal its whole-frame rows bit for bit: that is
what makes the band frame's G-buffer (parallel/band.py) the one-device
G-buffer. Against vkr_tpu each test states its bound. vkr_tpu runs
eagerly, its kernels interpreted at a small size as its own tests run them
(the interpret compiles are most of this file's time)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.passes import sampling as jsamp
from vkr_tpu.raster import gather_kernel as jgk
from vkr_tpu_torch.passes import sampling as tsamp
from vkr_tpu_torch.raster import gather_kernel as tgk

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _bitwise_bands(full_fn, band_fn, height, bands=2):
    """Each band's output equals the whole call's rows bit for bit."""
    full = _np(full_fn())
    bh = height // bands
    for b in range(bands):
        got = _np(band_fn(b * bh, bh))
        np.testing.assert_array_equal(got, full[b * bh:(b + 1) * bh],
                                      err_msg=f"band {b}")
    return full


# ------------------------------------------------------------------ raster

def test_band_viewport_raster_matches_full():
    """vkr_tpu's test_band_viewport_raster_matches_full on the port: two
    half-height bands through K7's plain version equal the whole frame bit
    for bit, and equal vkr_tpu's interpreted K7 at the same band
    viewport."""
    from vkr_tpu.raster import rasterize as jrasterize
    from vkr_tpu_torch.raster.pipeline import rasterize

    rng = np.random.default_rng(5)
    n = 40
    center = rng.uniform(-1.2, 1.2, (n, 1, 2))
    offs = rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.05, 0.95, (n, 3, 1))
    v = np.concatenate([center + offs, z, np.ones((n, 3, 1))],
                       -1).astype(np.float32)
    clip = v.reshape(-1, 4)
    idx = np.arange(n * 3, dtype=np.int32).reshape(n, 3)

    def port(**kw):
        return rasterize(clip=_t(clip), indices=_t(idx).long(), width=128,
                         **kw)

    full = port(height=64)
    assert (full.tri_id >= 0).float().mean() > 0.2
    for b in range(2):
        band = port(height=32, full_height=64, y_offset=32 * b)
        want = jrasterize(jnp.asarray(clip), jnp.asarray(idx), width=128,
                          height=32, use_pallas=True, interpret=True,
                          full_height=64,
                          y_offset=jnp.asarray(32 * b, jnp.float32))
        for name, field in (("depth", "depth"), ("tri_id", "tri_id")):
            got = _np(getattr(band, field))
            np.testing.assert_array_equal(
                got, _np(getattr(full, field))[32 * b:32 * (b + 1)],
                err_msg=f"band {b} {name} vs the whole frame")
            np.testing.assert_array_equal(got, np.asarray(
                getattr(want, field)), err_msg=f"band {b} {name} vs vkr_tpu")


def test_gbuf_tiles_band_starting_mid_tile():
    """K1's plain version at a 12-row band from row 12 of a 48-row frame
    (the band starts and ends inside 8-row tiles): depth and ids equal the
    whole frame's rows and vkr_tpu's interpreted kernel at the same
    offset, attributes bit for bit against the whole frame and within
    1e-5 of vkr_tpu (test_torch_raster.py's bound)."""
    from vkr_tpu.raster import gbuf_kernel as jgbk
    from vkr_tpu.raster import pair_rows as jrows
    from vkr_tpu.raster import setup as jsetup
    from vkr_tpu_torch.raster import gbuf_kernel as tgbk
    from vkr_tpu_torch.raster import pair_rows as trows
    from vkr_tpu_torch.raster import setup as tsetup

    fh, w, r0, bh = 48, 128, 12, 12
    rng = np.random.default_rng(8)
    n = 60
    cen = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    corners = []
    for _ in range(3):
        p = cen + 0.4 * (rng.random((n, 3)).astype(np.float32) - 0.5)
        corners.append(np.concatenate([p[:, :2], p[:, 2:3] * 0.5 + 0.5,
                                       np.ones((n, 1), np.float32)], 1))
    clip_t = np.ascontiguousarray(np.concatenate(corners, 0).T)
    attr_t = rng.random((9, 3 * n)).astype(np.float32)
    mat = rng.integers(0, 5, 2 * n).astype(np.int32)

    def port(height, **band):
        tri2, wts, valid = tsetup.clip_near_corners_t(_t(clip_t), n)
        st = tsetup.triangle_setup_t(tsetup.corners_from_weights_t(tri2, wts),
                                     valid, w, height, None, **band)
        ptri, ss, sc, _ = tsetup.bin_triangles_t(st.bbox, st.valid, w,
                                                 height, 8, 128, None)
        rows = trows.expand_pair_rows(trows.build_tri_rows_t(
            st, trows.corner_attributes_pre_t(_t(attr_t), wts, n),
            _t(mat)), ptri)
        return tgbk.gbuf_tiles(rows, ss, sc, width=w, height=height,
                               row_offset=band.get("y_offset", 0))

    full = [_np(a) for a in port(fh)]
    got = [_np(a) for a in port(bh, full_height=fh, y_offset=r0)]
    assert (got[1][:bh] >= 0).mean() > 0.1
    np.testing.assert_array_equal(got[0][:bh], full[0][r0:r0 + bh])
    np.testing.assert_array_equal(got[1][:bh], full[1][r0:r0 + bh])
    np.testing.assert_array_equal(got[2][:, :bh], full[2][:, r0:r0 + bh])

    tri2, wts, valid = jsetup.clip_near_corners_t(jnp.asarray(clip_t), n)
    st = jsetup.triangle_setup_t(jsetup._corners_from_weights_t(tri2, wts),
                                 valid, w, bh, None, full_height=fh,
                                 y_offset=r0)
    ptri, ss, sc, ov = jsetup.bin_triangles_t(st.bbox, st.valid, w, bh, 8,
                                              128, 4096)
    assert int(ov) == 0
    rows = jrows.expand_pair_rows(jrows.build_tri_rows_t(
        st, jrows.corner_attributes_pre_t(jnp.asarray(attr_t), wts, n),
        jnp.asarray(mat)), ptri)
    want = [np.asarray(a) for a in jgbk.gbuf_tiles(
        rows, ss, sc, None, jnp.asarray(r0, jnp.int32), width=w, height=bh,
        interpret=True)]
    np.testing.assert_array_equal(got[0][:bh], want[0][:bh])
    np.testing.assert_array_equal(got[1][:bh], want[1][:bh])
    np.testing.assert_allclose(got[2][:, :bh], want[2][:, :bh], atol=1e-5)


def test_band_oracle_resolve_matches_full_frame():
    """vkr_tpu's test_band_oracle_resolve_matches_full_frame on the port:
    the oracle G-buffer's bands (the brute-force raster and the gather
    resolve at the band's global rows) equal the whole G-buffer's rows bit
    for bit, and match vkr_tpu's oracle band (use_pallas=False, eager) on
    the colonnade at 64x128 (band 1; vkr_tpu's eager oracle is most of
    this test's time) to the repo's 40 dB per channel, the bar its whole
    frames are held to. Measured: whole frames 83.6 dB (normal) to 186.7
    dB (material), depth 134.3 dB with equal bits on 0.849 of the covered
    pixels (vkr_tpu's oracle loop is compiled: XLA contracts its depth
    plane)."""
    from vkr_tpu.passes.gbuffer import render_gbuffer as jrender
    from vkr_tpu.passes.gbuffer import upload_scene as jupload
    from vkr_tpu.scene import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.mathlib.transforms import look_at, perspective
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer

    scene_np = colonnade_scene(columns=2, tessellation=6, tex_size=32)
    h, w = 64, 128
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    vp = (perspective(75.0, w / h, 0.05, 80.0) @ view).astype(np.float32)
    scene = scene_from_numpy(scene_np, "cpu")
    jscene = jupload(scene_np)
    names = ("albedo", "normal", "material", "depth", "velocity")
    full = render_gbuffer(scene, _t(vp), _t(vp), torch.zeros(2), width=w,
                          height=h, oracle=True)
    assert (full.depth < 1.0).float().mean() > 0.3
    for b in range(2):
        r0 = b * (h // 2)
        band = render_gbuffer(scene, _t(vp), _t(vp), torch.zeros(2),
                              width=w, height=h // 2, oracle=True,
                              full_height=h, row_offset=r0)
        for name in names:
            np.testing.assert_array_equal(
                _np(getattr(band, name)),
                _np(getattr(full, name))[r0:r0 + h // 2],
                err_msg=f"band {b} {name}")
    want = jrender(jscene, jnp.asarray(vp), jnp.asarray(vp), jnp.zeros(2),
                   width=w, height=h // 2, use_pallas=False, full_height=h,
                   row_offset=h // 2)
    for name in names:
        got = _np(getattr(band, name))
        assert psnr(got, np.asarray(getattr(want, name))) >= 40.0, name
    assert (_np(band.depth) < 1.0).mean() > 0.3


# ----------------------------------------------------- gathers, sampling

R = 4


@pytest.mark.parametrize("kind", ["k5_1", "k5_2", "k4", "k6"])
def test_gather_band_rows(kind):
    """K4/K5/K6's plain versions with row0: bit for bit the whole call's
    rows, and within test_torch_gather.py's 1e-5 of vkr_tpu's interpreted
    kernel with the same row0 (rows 8-19 of a 21-row image, offsets past
    +-R and off the frame's edges)."""
    rng = np.random.default_rng(len(kind))
    h, w, r0, bh = 21, 200, 8, 12
    k = 3 if kind == "k4" else None
    oshape = (h, w) if k is None else (k, h, w)
    off_y = rng.uniform(-R - 3, R + 3, oshape).astype(np.float32)
    off_x = rng.uniform(-R - 3, R + 3, oshape).astype(np.float32)
    band = (slice(None), slice(r0, r0 + bh)) if k else (slice(r0, r0 + bh),)
    if kind.startswith("k5"):
        c = int(kind[-1])
        img = rng.random((h, w) if c == 1 else (h, w, c)).astype(np.float32)
        port = functools.partial(tgk.window_gather_bilinear, _t(img),
                                 radius=R)
        jax_band = jgk.window_gather_bilinear(
            jnp.asarray(img), jnp.asarray(off_y[band]),
            jnp.asarray(off_x[band]), radius=R, interpret=True, row0=r0)
    elif kind == "k4":
        img = rng.random((h, w)).astype(np.float32)
        port = functools.partial(tgk.window_gather_bilinear_multi, _t(img),
                                 radius=R)
        jax_band = jgk.window_gather_bilinear_multi(
            jnp.asarray(img), jnp.asarray(off_y[band]),
            jnp.asarray(off_x[band]), radius=R, interpret=True, row0=r0)
    else:
        color = rng.random((h, w, 3)).astype(np.float32)
        depth = rng.random((h, w)).astype(np.float32)
        port = functools.partial(tgk.taa_history_gather, _t(color),
                                 _t(depth), radius=R)
        hist, taps, pd = jgk.taa_history_gather(
            jnp.asarray(color), jnp.asarray(depth), jnp.asarray(off_y[band]),
            jnp.asarray(off_x[band]), radius=R, interpret=True, row0=r0)
        jax_band = np.concatenate(
            [np.moveaxis(np.asarray(x), -1, 0) for x in [hist] + taps]
            + [np.asarray(pd)[None]])
    full = _np(port(_t(off_y), _t(off_x)))
    got = _np(port(_t(off_y[band]), _t(off_x[band]), row0=r0))
    if kind in ("k4", "k6"):
        np.testing.assert_array_equal(got, full[:, r0:r0 + bh])
    else:
        np.testing.assert_array_equal(got, full[r0:r0 + bh])
    np.testing.assert_allclose(got, np.asarray(jax_band), rtol=0, atol=1e-5)


def test_screen_uv_and_reproject_band():
    """screen_uv_grid's band rows equal vkr_tpu's and the whole grid's;
    reproject_bilinear with row0 equals the whole call's rows bit for bit
    and vkr_tpu's band form (its dense path: no offset here reaches the
    clamp) within 1e-5 (test_torch_passes.py's TAA bound)."""
    g = _np(tsamp.screen_uv_grid(12, 40, "cpu", row0=8, full_height=30))
    np.testing.assert_array_equal(
        g, np.asarray(jsamp.screen_uv_grid(12, 40, row0=8, full_height=30)))
    np.testing.assert_array_equal(g, _np(tsamp.screen_uv_grid(
        30, 40, "cpu"))[8:20])
    rng = np.random.default_rng(2)
    img = rng.random((30, 40, 3)).astype(np.float32)
    uv_off = (rng.uniform(-3, 3, (30, 40, 2)) / np.float32([40, 30])
              ).astype(np.float32)
    _bitwise_bands(
        lambda: tsamp.reproject_bilinear(_t(img), _t(uv_off)),
        lambda r0, bh: tsamp.reproject_bilinear(
            _t(img), _t(uv_off[r0:r0 + bh]), row0=r0), 30)
    got = _np(tsamp.reproject_bilinear(_t(img), _t(uv_off[10:20]), row0=10))
    want = np.asarray(jsamp.reproject_bilinear(
        jnp.asarray(img), jnp.asarray(uv_off[10:20]), use_kernel=False,
        row0=10))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
