"""The generic (indexed) raster front end and the oracle raster of
vkr_tpu_torch against vkr_tpu's (raster/setup.py's row-major functions,
pair_rows.build_tri_rows, resolve.py, kernel.rasterize_reference), and the
indexed path against the port's own corner path. vkr_tpu runs eagerly
unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.raster import kernel as jkernel
from vkr_tpu.raster import pair_rows as jrows
from vkr_tpu.raster import resolve as jresolve
from vkr_tpu.raster import setup as jsetup
from vkr_tpu_torch.raster import kernel as tkernel
from vkr_tpu_torch.raster import pair_rows as trows
from vkr_tpu_torch.raster import resolve as tresolve
from vkr_tpu_torch.raster import setup as tsetup
from vkr_tpu_torch.raster.pipeline import rasterize

torch.set_num_threads(1)

W, H = 256, 128
JITTER = np.asarray([0.3 / W, -0.2 / H], np.float32)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _mesh(seed, n, spread=0.3):
    """n random clip-space triangles over a shuffled shared vertex pool:
    clip (V, 4), indices (n, 3), per-vertex attributes (V, 9), materials;
    some triangles cross the near plane."""
    rng = np.random.default_rng(seed)
    cen = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wv = (1 + 4 * rng.random((n, 1))).astype(np.float32)
    corners = []
    for _ in range(3):
        p = cen + spread * (rng.random((n, 3)).astype(np.float32) - 0.5)
        z = p[:, 2:3] * 0.5 + 0.5 - 0.1 * (rng.random((n, 1)) < 0.2)
        corners.append(np.concatenate([p[:, :2] * wv, z * wv, wv], 1))
    verts = np.stack(corners, 1).reshape(-1, 4).astype(np.float32)
    perm = rng.permutation(3 * n)
    clip = np.empty_like(verts)
    clip[perm] = verts
    indices = perm.reshape(n, 3).astype(np.int32)
    attrs = rng.random((3 * n, 9)).astype(np.float32)
    mat = rng.integers(0, 5, n).astype(np.int32)
    return clip, indices, attrs, mat


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _front_ends(tile_w):
    clip, idx, attrs, mat = _mesh(3, 150)
    cap = 4096
    # vkr_tpu's generic front end
    jc, jw, jsrc, jvalid = jsetup.clip_near_triangles(jnp.asarray(clip),
                                                      jnp.asarray(idx))
    js = jsetup.triangle_setup(jc, jvalid, W, H, jnp.asarray(JITTER))
    jbins = jsetup.bin_triangles(js, W, H, 8, tile_w, cap)
    jca = jresolve.corner_attributes(jnp.asarray(attrs), jnp.asarray(idx),
                                     jw, jsrc)
    jtri = jrows.build_tri_rows(js, jca, jnp.asarray(mat)[jsrc])
    # vkr_tpu's SoA twin of the same rows (its static-scene path)
    n = idx.shape[0]
    ct = jnp.asarray(clip[idx].transpose(2, 1, 0).reshape(4, 3 * n))
    at = jnp.asarray(attrs[idx].transpose(2, 1, 0).reshape(9, 3 * n))
    tri2, wt, valid = jsetup.clip_near_corners_t(ct, n)
    st = jsetup.triangle_setup_t(jsetup._corners_from_weights_t(tri2, wt),
                                 valid, W, H, jnp.asarray(JITTER))
    jtri_t = jrows.build_tri_rows_t(
        st, jrows.corner_attributes_pre_t(at, wt, n),
        jnp.concatenate([jnp.asarray(mat)] * 2))
    # the port's: the oracle's row-major setup, and the binning and rows
    # of the indexed path, which gathers the same corner tables
    tc, tw, tsrc, tvalid = tsetup.clip_near_triangles(_t(clip),
                                                      _t(idx).long())
    ts = tsetup.triangle_setup(tc, tvalid, W, H, _t(JITTER))
    tca = tresolve.corner_attributes(_t(attrs), _t(idx).long(), tw, tsrc)
    ct = tsetup.corner_table(_t(clip), _t(idx).long())
    tri2, wt, valid = tsetup.clip_near_corners_t(ct, n)
    st = tsetup.triangle_setup_t(tsetup.corners_from_weights_t(tri2, wt),
                                 valid, W, H, _t(JITTER))
    tbins = tsetup.bin_triangles_t(st.bbox, st.valid, W, H, 8, tile_w, cap)
    ttri = trows.build_tri_rows_t(
        st, trows.corner_attributes_pre_t(
            tsetup.corner_table(_t(attrs), _t(idx).long()), wt, n),
        torch.cat([_t(mat)] * 2))
    return ((jc, jw, jsrc, jvalid, js, jbins, jca, (jtri, jtri_t)),
            (tc, tw, tsrc, tvalid, ts, tbins, tca, ttri))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("tile_w", [128, 512])
def test_setup_bins_and_rows_equal_vkr_tpu(tile_w):
    """clip_near_triangles, triangle_setup and the corner attributes (the
    oracle's front end) equal vkr_tpu's bit for bit. The indexed path's
    binning (bin_triangles_t on the gathered corner tables) equals
    vkr_tpu's bin_triangles, and its rows (build_tri_rows_t) equal
    vkr_tpu's build_tri_rows on the raster fields, the denominator and the
    material, and on every field vkr_tpu's SoA twin (build_tri_rows_t, its
    static-scene path), whose arithmetic the port's shares. vkr_tpu's row-major form
    takes its 27 attribute planes from an einsum with its own accumulation
    (tests/test_raster.py::TestSoAFrontEnd leaves them to a tolerance);
    where the plane's three terms cancel, that moves the result by up to
    a few ulps of the terms, not of the sum."""
    (jc, jw, jsrc, jvalid, js, jbins, jca, jtri), (
        tc, tw, tsrc, tvalid, ts, tbins, tca, ttri) = _front_ends(tile_w)
    for name, g, w in (("corners", tc, jc), ("weights", tw, jw),
                       ("src", tsrc, jsrc), ("valid", tvalid, jvalid)):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    assert (~_np(tvalid)).any() and _np(tvalid)[150:].any()  # clipped
    for f in ts._fields:
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      _np(getattr(js, f)), err_msg=f)
    for name, g, w in zip(("pair_tri", "seg_starts", "seg_counts",
                           "overflow"), tbins, jbins):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    assert int(_np(tbins[2]).sum()) > 200
    np.testing.assert_array_equal(_np(tca), _np(jca))
    g, (w, w_soa) = _np(ttri), (_np(r) for r in jtri)
    np.testing.assert_array_equal(g, w_soa)
    np.testing.assert_array_equal(g[:, :19], w[:, :19])
    np.testing.assert_array_equal(g[:, 46:], w[:, 46:])
    gap = np.abs(w[:, 19:46] - w_soa[:, 19:46]).max()
    print(f"vkr_tpu's row-major attribute planes vs its SoA twin: max {gap}")


def test_transforms_equal_vkr_tpu():
    """transform_vertices and transform_normals against vkr_tpu's on a
    scene's own vertex arrays, within a float32 ulp of the dot order."""
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene
    from vkr_tpu_torch.mathlib.transforms import perspective

    sc = colonnade_scene(columns=2, tessellation=8, tex_size=32)
    vp = (perspective(1.0, 2.0, 0.1, 100.0) @ bench_orbit_view(1)).astype(
        np.float32)
    want = jsetup.transform_vertices(
        jnp.asarray(sc.positions), jnp.asarray(sc.vert_transform),
        jnp.asarray(sc.transforms), jnp.asarray(vp))
    got = tsetup.transform_vertices(
        _t(sc.positions), _t(sc.vert_transform).long(), _t(sc.transforms),
        _t(vp))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    want_n = jsetup.transform_normals(
        jnp.asarray(sc.normals), jnp.asarray(sc.vert_transform),
        jnp.asarray(sc.normal_mats))
    got_n = tsetup.transform_normals(_t(sc.normals),
                                     _t(sc.vert_transform).long(),
                                     _t(sc.normal_mats))
    np.testing.assert_allclose(_np(got_n), _np(want_n), rtol=0, atol=1e-6)


def _corner_inputs(clip, idx, attrs):
    """The same triangles as pre-gathered corner tables (4, 3T), (9, 3T),
    gathered in numpy."""
    n = idx.shape[0]
    ct = clip[idx].transpose(2, 1, 0).reshape(4, 3 * n)
    at = attrs[idx].transpose(2, 1, 0).reshape(9, 3 * n)
    return _t(ct), _t(at)


def test_corner_table_is_the_corner_layout():
    """corner_table, the indexed path's gather, lays the triangles out as
    the corner path's tables: component-major, corner-major columns."""
    clip, idx, attrs, _ = _mesh(7, 40)
    ct, at = _corner_inputs(clip, idx, attrs)
    ti = _t(idx).long()
    torch.testing.assert_close(tsetup.corner_table(_t(clip), ti), ct,
                               rtol=0, atol=0)
    torch.testing.assert_close(tsetup.corner_table(_t(attrs), ti), at,
                               rtol=0, atol=0)


@pytest.mark.parametrize("tile_w", [128, 512])
def test_indexed_rasterize_equals_corner_path(tile_w):
    """The indexed front end ends in the same pair rows as the corner
    path, so K1's outputs (depth, ids, resolved attributes) are equal bit
    for bit, with a peel rerun and for the visibility-only raster (K7)."""
    clip, idx, attrs, mat = _mesh(4, 200)
    ct, at = _corner_inputs(clip, idx, attrs)
    kw = dict(width=W, height=H, jitter=_t(JITTER), tile_w=tile_w)
    a = rasterize(ct, at, _t(mat), keep_prepared=True, **kw)
    b = rasterize(clip=_t(clip), indices=_t(idx).long(), vertex_attrs=_t(
        attrs), tri_mat=_t(mat), keep_prepared=True, **kw)
    assert (a.tri_id >= 0).float().mean() > 0.2
    for x, y in ((a.depth, b.depth), (a.tri_id, b.tri_id),
                 (a.resolved, b.resolved), (a.overflow, b.overflow),
                 (a.prepared.pair_rows, b.prepared.pair_rows)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    peel = a.depth + 1e-3
    pa = rasterize(peel_depth=peel, prepared=a, **kw)
    pb = rasterize(peel_depth=peel, prepared=b, **kw)
    torch.testing.assert_close(pa.resolved, pb.resolved, rtol=0, atol=0)
    va = rasterize(ct, **kw)
    vb = rasterize(clip=_t(clip), indices=_t(idx).long(), **kw)
    torch.testing.assert_close(va.tri_id, vb.tri_id, rtol=0, atol=0)
    torch.testing.assert_close(va.depth, vb.depth, rtol=0, atol=0)


def test_indexed_gbuffer_equals_corner_gbuffer():
    """render_gbuffer of a scene without corner tables (the indexed front
    end) equals the corner path's on every channel, bit for bit (vkr_tpu
    states the same of its two paths, gbuffer.py:266-270)."""
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H, trilinear_textures=True)
    scene = upload_scene(colonnade_scene(columns=8, tessellation=8,
                                         tex_size=32), "cpu")
    indexed = scene._replace(corner_world_o=None, corner_attr_o=None,
                             corner_world_m=None, corner_attr_m=None)
    cam = camera_frame(cfg, bench_orbit_view(2), bench_orbit_view(1), 2,
                       "cpu")
    kw = dict(width=W, height=H, mask_peel_layers=2, trilinear=True)
    a = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter, **kw)
    b = render_gbuffer(indexed, cam.mvp, cam.prev_mvp, cam.jitter, **kw)
    for name in a._fields:
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0, msg=name)
    assert float((a.depth < 1.0).float().mean()) > 0.9


def test_rasterize_reference_against_vkr_tpu():
    """The port's oracle against vkr_tpu's rasterize_reference, which runs
    as a compiled fori_loop (XLA contracts its plane arithmetic); both on
    the same setup, with and without a peel floor. The port evaluates the
    planes as K1 does (fma(a, px, b*py) + c). Found on this input: the
    ids agree on every pixel (1.000000 with and without the floor), the
    depth within 2e-7 where both cover; held to 0.999 of the ids (a
    knife-edge pixel may flip where XLA contracts a plane differently) and
    2e-7."""
    (_, _, _, _, js, _, _, _), (_, _, _, _, ts, _, _, _) = _front_ends(128)
    rng = np.random.default_rng(6)
    for peel in (None, (rng.random((H, W)) * 0.6).astype(np.float32)):
        jz, jid = jax.jit(lambda s, p: jkernel.rasterize_reference(
            s, W, H, peel_depth=p))(js, None if peel is None
                                    else jnp.asarray(peel))
        tz, tid = tkernel.rasterize_reference(
            ts, W, H, peel_depth=None if peel is None else _t(peel))
        jid, tid = _np(jid), _np(tid)
        assert (tid >= 0).mean() > 0.1
        same = (jid == tid).mean()
        print(f"peel {peel is not None}: ids equal on {same:.6f}")
        assert same >= 0.999
        both = (jid >= 0) & (tid >= 0)
        np.testing.assert_allclose(_np(tz)[both], _np(jz)[both], rtol=0,
                                   atol=2e-7)


def test_oracle_resolve_equals_vkr_tpu():
    """pixel_barycentrics + interpolate_many on the oracle's winners, as
    vkr_tpu's gather resolve computes them (eager), within 1e-6."""
    (_, jw, jsrc, _, js, _, _, _), (_, tw, tsrc, _, ts, _, _, _) = \
        _front_ends(128)
    tz, tid = tkernel.rasterize_reference(ts, W, H)
    clip, idx, attrs, _ = _mesh(3, 150)
    jb, _ = jresolve.pixel_barycentrics(jnp.asarray(_np(tid)), js, W, H)
    tb, _ = tresolve.pixel_barycentrics(tid, ts, W, H)
    np.testing.assert_allclose(_np(tb), _np(jb), rtol=0, atol=1e-6)
    jv = jresolve.interpolate_many(
        {"a": jresolve.corner_attributes(jnp.asarray(attrs),
                                         jnp.asarray(idx), jw, jsrc)},
        jnp.asarray(_np(tid)), jb)["a"]
    tv = tresolve.interpolate_many(
        {"a": tresolve.corner_attributes(_t(attrs), _t(idx).long(), tw,
                                         tsrc)}, tid, tb)["a"]
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=0, atol=1e-6)


def test_oracle_requires_indexed_inputs():
    clip, idx, attrs, mat = _mesh(5, 10)
    ct, at = _corner_inputs(clip, idx, attrs)
    with pytest.raises(ValueError, match="indexed"):
        rasterize(ct, at, _t(mat), width=W, height=H, oracle=True)
