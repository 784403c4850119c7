"""Band mode (the multi-device frame's row bands) of every image-space pass
of the port, against vkr_tpu's band form on the same whole-frame inputs,
and against the rows of the port's own whole-frame call
(tests/test_torch_band_raster.py holds the raster and the gathers).

The port's band rows must equal its whole-frame rows bit for bit: that is
what makes the band frame (parallel/band.py) the one-device frame. The
tolerance against vkr_tpu is the one the pass's whole-frame test uses
(stated in each test). Two of vkr_tpu's band forms scale by the band's
height where the frame's belongs (the SSR filter's uv step, ssr.py:735;
GTAO accumulate's velocity length, gtao.py:886-887): the port's band rows
are held to vkr_tpu's whole-frame rows there (ROADMAP queue 3).

The SSR, MIS GTAO, ray-traced GTAO and probe inputs are the port's frames
0 and 1 of the bench orbit in the 24-column hall at 128x64, where SSR rays
hit in both half-height bands; the GTAO filter, accumulation, shading and
TAA take test_torch_passes.py's frames (orbit frames 1 and 2 of the
6-column colonnade at 128x64), whose bounds they keep. vkr_tpu runs
eagerly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.passes import gtao as jgtao
from vkr_tpu.passes import shading as jshade
from vkr_tpu.passes import ssr as jssr
from vkr_tpu.passes import taa as jtaa
from vkr_tpu.raster import gather_kernel as jgk
from vkr_tpu_torch.passes import gtao as tgtao
from vkr_tpu_torch.passes import sampling as tsamp
from vkr_tpu_torch.passes import shading as tshade
from vkr_tpu_torch.passes import ssr as tssr
from vkr_tpu_torch.passes import taa as ttaa

torch.set_num_threads(1)

W, H = 128, 64
HH = H // 2          # half-res rows
BANDS = 2
R0, BH = HH // BANDS, HH // BANDS   # the second half-res band
LUT = 32
MAX_IT = 40


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _bitwise_bands(full_fn, band_fn, height, bands=BANDS):
    """Each band's output equals the whole call's rows bit for bit."""
    full = _np(full_fn())
    bh = height // bands
    for b in range(bands):
        got = _np(band_fn(b * bh, bh))
        np.testing.assert_array_equal(got, full[b * bh:(b + 1) * bh],
                                      err_msg=f"band {b}")
    return full


# ------------------------------------------------- the hall's frame inputs

@pytest.fixture(scope="module")
def hall():
    """The port's G-buffers, hi-Z and SSR trace of orbit frames 0 and 1 in
    the 24-column hall at 128x64 (numpy), the frame's parameters, and the
    port's SSR LUTs."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.mathlib.brdf import halton23_table
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=32), "cpu")
    frames = []
    for i in (0, 1):
        cam = camera_frame(cfg, bench_orbit_view(i),
                           bench_orbit_view(max(i - 1, 0)), i, "cpu")
        g = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter,
                           width=W, height=H, mask_peel_layers=2)
        hiz = build_hiz(g.depth, g.normal, g.velocity)
        frames.append((g, hiz, cam))
    (g0, hiz0, _), (g, hiz, cam) = frames
    p = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
             znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    nm = _np(_normal_mat4(cam.view))
    pdf = _np(tssr.preintegrate_pdf(LUT, device="cpu"))
    halton = halton23_table(tssr.HALTON_SEQ_SIZE)
    pyr = tssr.pack_pyramid(hiz.mips)
    rays, occ = tssr.ssr_trace(pyr, hiz.normal_half, g.material, _t(pdf),
                               tssr.SSRParams(normal_mat=_t(nm), **p), 1,
                               _t(halton), MAX_IT)
    valid = _np(rays)[..., 3] != 1.0
    return dict(
        cfg=cfg, p=p, nm=nm, pdf=pdf, halton=halton,
        mips=[_np(m) for m in hiz.mips], normal_half=_np(hiz.normal_half),
        velocity_half=_np(hiz.velocity_half),
        prev_depth_half=_np(hiz0.mips[0]),
        g={k: _np(getattr(g, k)) for k in ("albedo", "normal", "material",
                                           "velocity", "depth")},
        prev_depth=_np(g0.depth), rays=_np(rays), occ=_np(occ),
        valid_per_band=[float(valid[b * BH:(b + 1) * BH].mean())
                        for b in range(BANDS)],
        inv_view=_np(_inv4(cam.view)), prev_inv_view=_np(_inv4(
            cam.prev_view)), mvp=_np(cam.mvp))


def test_ssr_hits_in_every_band(hall):
    assert min(hall["valid_per_band"]) > 0.02, hall["valid_per_band"]


def _tparams(hall):
    return tssr.SSRParams(normal_mat=_t(hall["nm"]), **hall["p"])


def _jparams(hall):
    return jssr.SSRParams(normal_mat=jnp.asarray(hall["nm"]), **hall["p"])


@pytest.fixture
def no_drop_band_march(monkeypatch):
    """vkr_tpu's band trace calls its Pallas march (compacting, dropping
    rays); the port drops none. Its no-drop oracle, `_hierarchical_march(
    ..., compact_frac=0.0)`, takes band rays as they are, as the
    whole-frame SSR tests hold it (test-only patch)."""
    import vkr_tpu.passes.ssr_march as jmarch

    def oracle(mips, origin, direction, camera_start, w0, params,
               max_iterations, compact_frac=0.5, interpret=False, row0=None):
        return jssr._hierarchical_march(
            jssr.pack_pyramid(mips), origin, direction, camera_start, w0,
            params, max_iterations, compact_frac=0.0)

    monkeypatch.setattr(jmarch, "hierarchical_march_pallas", oracle)


def test_ssr_trace_band(hall, no_drop_band_march):
    """Band rays: bit for bit the whole trace's rows (the march takes the
    band's rays against the whole pyramid; no .cu change, ssr_march.py),
    and against vkr_tpu's band trace, jitted as in its frame,
    test_torch_ssr.py's bounds: validity
    agreement >= 0.999, hit uv within a texel at p99, occlusion within
    1e-3 on 99% of the pixels. Validity is compared where both packages
    pick the same Halton row: vkr_tpu's rand() takes XLA's float32 sin,
    which moves the row of a few pixels (test_torch_ssr.py's
    test_halton_index_share, ROADMAP queue 3), and such a pixel traces
    another ray."""
    from vkr_tpu.passes.sampling import screen_uv_grid as juv

    pyr = tssr.pack_pyramid([_t(m) for m in hall["mips"]])
    args = (_t(hall["normal_half"]), _t(hall["g"]["material"]),
            _t(hall["pdf"]), _tparams(hall), 1, _t(hall["halton"]), MAX_IT)
    for b in range(BANDS):
        rays, occ = tssr.ssr_trace(pyr, *args, row0=b * BH, band_h=BH)
        np.testing.assert_array_equal(_np(rays),
                                      hall["rays"][b * BH:(b + 1) * BH])
        np.testing.assert_array_equal(_np(occ),
                                      hall["occ"][b * BH:(b + 1) * BH])
    jpyr = jssr.pack_pyramid([jnp.asarray(m) for m in hall["mips"]])
    jrays, jocc = (np.asarray(a) for a in jax.jit(
        lambda flat, n, m, pdf: jssr.ssr_trace(
            jpyr._replace(flat=flat), n, m, pdf, _jparams(hall),
            jnp.asarray(1), jnp.asarray(hall["halton"]),
            max_iterations=MAX_IT, row0=R0, band_h=BH))(
        jpyr.flat, hall["normal_half"], hall["g"]["material"], hall["pdf"]))
    rg, og = hall["rays"][R0:R0 + BH], hall["occ"][R0:R0 + BH]
    vw, vg = jrays[..., 3] != 1.0, rg[..., 3] != 1.0
    same_row = np.asarray(jax.jit(lambda: (jssr._shader_rand(juv(
        BH, W // 2, row0=R0, full_height=HH)) * 128).astype(jnp.uint32))()
    ) == _np(tssr._halton_index(tsamp.screen_uv_grid(
        BH, W // 2, "cpu", row0=R0, full_height=HH), 0))
    assert vg.mean() > 0.02 and same_row.mean() >= 0.99
    assert (vw == vg)[same_row].mean() >= 0.999
    both = vw & vg
    hit = np.abs(jrays[..., :2] - rg[..., :2])[both].max(-1) * (W // 2)
    assert np.percentile(hit, 99) < 1.0
    assert (np.abs(jocc[..., 0] - og[..., 0]) <= 1e-3).mean() >= 0.99


def test_ssr_filter_band(hall):
    """Bit for bit the whole filter's rows (the one-row halo replicates
    the frame's edges, ssr.py:700-705), and within test_torch_ssr.py's
    1e-5 + 1e-3 relative of vkr_tpu's whole filter's rows: vkr_tpu's band
    form takes its uv step as 1/band_h (ssr.py:735)."""
    args = (_t(hall["rays"]), _t(hall["mips"][0]), _t(hall["g"]["albedo"]),
            _t(hall["normal_half"]), _t(hall["g"]["material"]),
            _tparams(hall))
    full = _bitwise_bands(
        lambda: tssr.ssr_filter(*args),
        lambda r0, bh: tssr.ssr_filter(*args, row0=r0, band_h=bh), HH)
    want = np.asarray(jssr.ssr_filter(
        jnp.asarray(hall["rays"]), jnp.asarray(hall["mips"][0]),
        jnp.asarray(hall["g"]["albedo"]), jnp.asarray(hall["normal_half"]),
        jnp.asarray(hall["g"]["material"]), _jparams(hall)))
    assert want[R0:].max() > 0.05
    np.testing.assert_allclose(full[R0:R0 + BH], want[R0:R0 + BH],
                               rtol=1e-3, atol=1e-5)


def _blur_params(hall, mod, conv, accumulate=True):
    return mod.SSRBlurParams(
        inverse_camera=conv(hall["inv_view"]),
        prev_inverse_camera=conv(hall["prev_inv_view"]),
        accumulate=accumulate, **hall["p"])


def test_ssr_blur_band(hall, monkeypatch):
    """Bit for bit the whole blur's rows (the 11-row halo replicates the
    frame's edges; the reprojection reads the whole previous depth), and
    within test_torch_ssr.py's 1e-5 of vkr_tpu's band blur (its K5 as its
    jnp oracle, as there)."""
    refl = _np(tssr.ssr_filter(
        _t(hall["rays"]), _t(hall["mips"][0]), _t(hall["g"]["albedo"]),
        _t(hall["normal_half"]), _t(hall["g"]["material"]), _tparams(hall)))
    hist = (np.random.default_rng(3).random(refl.shape) * 0.5
            ).astype(np.float32)
    arrays = (refl, hall["mips"][0], hall["normal_half"],
              hall["g"]["material"], hist, hall["velocity_half"],
              hall["prev_depth_half"])
    tp = _blur_params(hall, tssr, _t)
    full = _bitwise_bands(
        lambda: tssr.ssr_blur(*(_t(a) for a in arrays), tp),
        lambda r0, bh: tssr.ssr_blur(*(_t(a) for a in arrays), tp, row0=r0,
                                     band_h=bh), HH)
    monkeypatch.setattr(jgk, "window_gather_bilinear", _jk5_oracle)
    want = np.asarray(jssr.ssr_blur(
        *(jnp.asarray(a) for a in arrays), _blur_params(hall, jssr,
                                                        jnp.asarray),
        use_kernel_gather=True, row0=R0, band_h=BH))
    assert np.abs(full - hist).max() > 0.01
    np.testing.assert_allclose(full[R0:R0 + BH], want, rtol=0, atol=1e-5)


def _jk5_oracle(img, off_y, off_x, radius=16, interpret=False, row0=None):
    """vkr_tpu's jnp oracle of its K5 (window_gather_reference, the
    function the kernel computes) for a band call: the band's offsets at
    rows [row0, row0 + bh) of whole-frame offsets, then the band's rows."""
    r0, bh = row0 or 0, off_y.shape[0]

    def whole(off):
        return jnp.zeros((img.shape[0],) + off.shape[1:], off.dtype).at[
            r0:r0 + bh].set(off)

    return jgk.window_gather_reference(img, whole(off_y), whole(off_x),
                                       radius)[r0:r0 + bh]


# -------------------------------------------------------------------- GTAO

def _gtao_params(hall, mod, conv):
    return mod.GTAOParams(normal_mat=conv(hall["nm"]), **hall["p"])


BASE_ANGLE = float(tgtao.frame_base_angle(1))  # a host float: both packages


def test_gtao_main_mis_band(hall):
    """Bit for bit the whole pass's rows (the dither class and uv of the
    global rows; K4's plain version with row0), and within
    test_torch_ssr.py's 3e-3 relative + 2e-4 of vkr_tpu's band pass (its
    bilinear_sample loop, use_kernel=False)."""
    arrays = (hall["mips"][0], hall["normal_half"], hall["g"]["material"],
              hall["pdf"], hall["occ"])
    tp = _gtao_params(hall, tgtao, _t)
    full = _bitwise_bands(
        lambda: tgtao.gtao_main_mis(*(_t(a) for a in arrays), tp,
                                    BASE_ANGLE),
        lambda r0, bh: tgtao.gtao_main_mis(*(_t(a) for a in arrays), tp,
                                           BASE_ANGLE, row0=r0, band_h=bh),
        HH)
    want = np.asarray(jgtao.gtao_main_mis(
        *(jnp.asarray(a) for a in arrays), _gtao_params(hall, jgtao,
                                                        jnp.asarray),
        jnp.float32(BASE_ANGLE), use_kernel=False, row0=R0, band_h=BH))
    assert full[R0:].max() > 0.1
    np.testing.assert_allclose(full[R0:R0 + BH], want, rtol=3e-3, atol=2e-4)


def _k4_oracle(img, off_y, off_x, *, radius, interpret, row0):
    """vkr_tpu's jnp K4 oracle (one window_gather_reference per offset
    set) for a band call."""
    return jnp.stack([_jk5_oracle(img, off_y[k], off_x[k], radius,
                                  row0=row0)
                      for k in range(off_y.shape[0])])


@pytest.mark.parametrize("name", ["gtao_main_window", "gtao_main_exact",
                                  "gtao_main_dense"])
def test_gtao_single_strategy_band(hall, name, monkeypatch):
    """The single-strategy main passes: bit for bit the whole pass's rows,
    and against vkr_tpu's band pass the 40 dB of
    test_torch_gtao_variants.py (its K4 as its jnp oracle, as
    test_torch_passes.py runs it)."""
    from vkr_tpu.raster import gather_kernel as jgather

    monkeypatch.setattr(jgather, "window_gather_bilinear_multi", _k4_oracle)
    args = (hall["mips"][0], hall["normal_half"])
    tp = _gtao_params(hall, tgtao, _t)
    fn = getattr(tgtao, name)
    full = _bitwise_bands(
        lambda: fn(*(_t(a) for a in args), tp, BASE_ANGLE),
        lambda r0, bh: fn(*(_t(a) for a in args), tp, BASE_ANGLE, row0=r0,
                          band_h=bh), HH)
    want = np.asarray(getattr(jgtao, name)(
        *(jnp.asarray(a) for a in args), _gtao_params(hall, jgtao,
                                                      jnp.asarray),
        jnp.float32(BASE_ANGLE), row0=R0, band_h=BH))
    got = full[R0:R0 + BH]
    print(f"{name} band: {psnr(got, want):.2f} dB, max abs "
          f"{np.abs(got - want).max():.3g}")
    assert want.std() > 0.05
    assert psnr(got, want) >= 40.0


def test_gtao_rt_band(hall):
    """Ray-traced GTAO, 16 directions, over the hall's grid (resolution
    16, cap 8, as test_torch_gtao_variants.py; the same grid on both
    sides): bit for bit the whole pass's rows, and
    within test_torch_gtao_variants.py's bound of vkr_tpu's band pass
    (40 dB; measured there: the same hits)."""
    from vkr_tpu.frame import build_scene_tri_grid as j_build
    from vkr_tpu.scene import colonnade_scene
    from vkr_tpu_torch.frame import build_scene_tri_grid as t_build

    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    dirs = tgtao.ao_ray_directions(16)
    tg = t_build(scene_np, resolution=16, cap=8, device="cpu")
    lens = tuple(hall["p"][k] for k in ("fovy", "aspect", "znear", "zfar"))
    args = (_t(hall["mips"][0]), _t(hall["normal_half"]), tg,
            _t(hall["inv_view"]), *lens, BASE_ANGLE, _t(dirs))
    full = _bitwise_bands(
        lambda: tgtao.gtao_rt(*args),
        lambda r0, bh: tgtao.gtao_rt(*args, row0=r0, band_h=bh), HH)
    want = np.asarray(jgtao.gtao_rt(
        jnp.asarray(hall["mips"][0]), jnp.asarray(hall["normal_half"]),
        j_build(scene_np, resolution=16, cap=8),
        jnp.asarray(hall["inv_view"]), *lens, BASE_ANGLE, jnp.asarray(dirs),
        row0=R0, band_h=BH))
    got = full[R0:R0 + BH]
    assert want.max() - want.min() > 0.2
    assert psnr(got, want) >= 40.0


def test_gtao_filter_band(hall):
    """Bit for bit the whole filter's rows (a 2-row halo replicating the
    frame's edges), and test_torch_passes.py's 1e-6 of vkr_tpu's band
    filter."""
    d = hall["mips"][0]
    raw = np.random.default_rng(2).random(d.shape).astype(np.float32)
    zn, zf = hall["p"]["znear"], hall["p"]["zfar"]
    full = _bitwise_bands(
        lambda: tgtao.gtao_filter(_t(d), _t(raw), zn, zf),
        lambda r0, bh: tgtao.gtao_filter(_t(d), _t(raw), zn, zf, row0=r0,
                                         band_h=bh), HH)
    want = np.asarray(jgtao.gtao_filter(jnp.asarray(d), jnp.asarray(raw),
                                        zn, zf, row0=R0, band_h=BH))
    np.testing.assert_allclose(full[R0:R0 + BH], want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def frames():
    """test_torch_passes.py's inputs: G-buffers and hi-Z of orbit frames 1
    and 2 of the 6-column colonnade at 128x64 (numpy), their cameras and
    the config."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, camera_frame
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H, enable_ssr=False)
    scene = upload_scene(colonnade_scene(columns=6, tessellation=8,
                                         tex_size=32), "cpu")
    out = []
    for i in (1, 2):
        cam = camera_frame(cfg, bench_orbit_view(i), bench_orbit_view(i - 1),
                           i, "cpu")
        g = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter,
                           width=W, height=H, quantize=True,
                           mask_peel_layers=2)
        hz = build_hiz(g.depth, g.normal, g.velocity)
        out.append(dict(
            g={k: _np(getattr(g, k)) for k in ("albedo", "normal",
                                               "material", "velocity",
                                               "depth")},
            depth_half=_np(hz.mips[0]), velocity_half=_np(hz.velocity_half),
            inv_view=_np(_inv4(cam.view)),
            prev_inv_view=_np(_inv4(cam.prev_view)), mvp=_np(cam.mvp)))
    p = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
             znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    return p, out


def _accum_params(p, fr, mod, conv):
    return mod.GTAOAccumParams(
        inverse_camera=conv(fr["inv_view"]),
        prev_inverse_camera=conv(fr["prev_inv_view"]), mvp=conv(fr["mvp"]),
        **p)


def test_gtao_accumulate_band(frames):
    """Bit for bit the whole pass's rows (K5's plain version with row0 for
    both reprojections), and within test_torch_passes.py's bounds (AO
    1e-5, the sample count 2e-4) of vkr_tpu's whole pass's rows (its K5
    interpreted, as there): its band form scales the velocity's rows by
    the band's height (gtao.py:886-887)."""
    p, (prev, cur) = frames
    rng = np.random.default_rng(3)
    d = cur["depth_half"]
    ao = rng.random(d.shape).astype(np.float32)
    hist = np.stack([rng.random(d.shape),
                     rng.integers(1, 256, d.shape) / 255.0],
                    -1).astype(np.float32)
    arrays = (d, prev["depth_half"], ao, cur["velocity_half"], hist)
    tp = _accum_params(p, cur, tgtao, _t)
    full = _bitwise_bands(
        lambda: tgtao.gtao_accumulate(*(_t(a) for a in arrays), tp, False),
        lambda r0, bh: tgtao.gtao_accumulate(*(_t(a) for a in arrays), tp,
                                             False, row0=r0, band_h=bh), HH)
    want = np.asarray(jgtao.gtao_accumulate(
        *(jnp.asarray(a) for a in arrays),
        _accum_params(p, cur, jgtao, jnp.asarray), jnp.bool_(False),
        use_kernel_gather=True, interpret=True))
    got, want = full[R0:R0 + BH], want[R0:R0 + BH]
    assert (np.abs(got[..., 1] - 1 / 255) > 1e-6).mean() > 0.5
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=2e-4)


# ---------------------------------------------------- shading, TAA, probes

def test_deferred_shading_band(frames):
    """Full-res rows [32, 64): bit for bit the whole pass's rows (the
    upsample reads a 2-row half-res halo), and test_torch_passes.py's 3e-6
    of vkr_tpu's band pass."""
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
    from vkr_tpu_torch.passes.gbuffer import GBuffer

    p, (_, cur) = frames
    rng = np.random.default_rng(4)
    d = cur["depth_half"]
    occ = rng.random(d.shape).astype(np.float32)
    refl = (0.2 * rng.random(d.shape + (3,))).astype(np.float32)
    lut = _np(tssr.preintegrate_brdf(32, num_samples=16, device="cpu"))
    kw = dict(min_roughness=0.1, max_roughness=0.9, **p)
    g = dict(cur["g"], overflow=np.int32(0))
    tg = GBuffer(**{k: _t(v) for k, v in g.items()})
    tpar = tshade.ShadingParams(inverse_camera=_t(cur["inv_view"]), **kw)
    targs = dict(occlusion=_t(occ), reflections=_t(refl), brdf_lut=_t(lut),
                 depth_half=_t(d))
    full = _bitwise_bands(
        lambda: tshade.deferred_shading(tg, tpar, **targs),
        lambda r0, bh: tshade.deferred_shading(tg, tpar, **targs, row0=r0,
                                               band_h=bh), H)
    want = np.asarray(jshade.deferred_shading(
        JGBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        jshade.ShadingParams(inverse_camera=jnp.asarray(cur["inv_view"]),
                             **kw),
        occlusion=jnp.asarray(occ), reflections=jnp.asarray(refl),
        brdf_lut=jnp.asarray(lut), depth_half=jnp.asarray(d), row0=2 * R0,
        band_h=2 * BH))
    np.testing.assert_allclose(full[2 * R0:], want, rtol=0, atol=3e-6)


def test_taa_resolve_band(frames):
    """Full-res rows [32, 64): bit for bit the whole pass's rows (K6's
    plain version with row0), and test_torch_passes.py's 1e-5 of vkr_tpu's
    band pass (its dense path; no offset of this frame reaches K6's
    clamp)."""
    p, (prev, cur) = frames
    rng = np.random.default_rng(5)
    hist = rng.random((H, W, 3)).astype(np.float32)
    color = rng.random((H, W, 3)).astype(np.float32)
    vel = cur["g"]["velocity"]
    assert np.abs(vel * np.float32([W, H])).max() + 1 < 16
    arrays = (hist, prev["g"]["depth"], cur["g"]["depth"], vel, color)
    tp = ttaa.TAAParams(inverse_camera=_t(cur["inv_view"]),
                        prev_inverse_camera=_t(cur["prev_inv_view"]), **p)
    full = _bitwise_bands(
        lambda: ttaa.taa_resolve(*(_t(a) for a in arrays), tp),
        lambda r0, bh: ttaa.taa_resolve(*(_t(a) for a in arrays), tp,
                                        row0=r0, band_h=bh), H)
    want = np.asarray(jtaa.taa_resolve(
        *(jnp.asarray(a) for a in arrays),
        jtaa.TAAParams(inverse_camera=jnp.asarray(cur["inv_view"]),
                       prev_inverse_camera=jnp.asarray(
                           cur["prev_inv_view"]), **p),
        use_kernel_gather=False, row0=2 * R0, band_h=2 * BH))
    assert (np.abs(full - color).max(-1) > 1e-3).mean() > 0.5
    np.testing.assert_allclose(full[2 * R0:], want, rtol=0, atol=1e-5)


def test_probe_trace_band(hall):
    """The probe trace over a 2x2 grid of 16^2 faces (the port's, carried
    to vkr_tpu): bit for bit the whole trace's rows, and against vkr_tpu's
    band trace test_torch_probes.py's bounds (outcome agreement >= 0.995,
    40 dB RGBA)."""
    import vkr_tpu.passes.probes as jp
    from vkr_tpu_torch.passes import probes as tp
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=32), "cpu")
    grid = tp.render_probe_grid(scene, (-20, 1.5, -4), (20, 1.5, 4),
                                grid_size=2, cube_size=16, oct_size=32)
    lens = tuple(hall["p"][k] for k in ("fovy", "aspect", "znear", "zfar"))
    args = (_t(hall["mips"][0]), _t(hall["normal_half"]), grid,
            _t(hall["inv_view"]), *lens)
    full = _bitwise_bands(
        lambda: tp.probe_trace(*args),
        lambda r0, bh: tp.probe_trace(*args, row0=r0, band_h=bh), HH)
    jgrid = jp.ProbeGrid(
        colors=jnp.asarray(_np(grid.colors)),
        depth_flat=jnp.asarray(_np(grid.depth_flat)),
        mip_offsets=grid.mip_offsets, mip_sizes=grid.mip_sizes,
        probe_min=jnp.asarray(_np(grid.probe_min)),
        probe_max=jnp.asarray(_np(grid.probe_max)), grid_size=2)
    want = np.asarray(jp.probe_trace(
        jnp.asarray(hall["mips"][0]), jnp.asarray(hall["normal_half"]),
        jgrid, jnp.asarray(hall["inv_view"]), *lens, row0=R0, band_h=BH))
    got = full[R0:R0 + BH]
    agree = float(((got[..., 3] > 0) == (want[..., 3] > 0)).mean())
    assert (got[..., 3] > 0).mean() > 0.05
    assert agree >= 0.995
    assert psnr(got, want) >= 40.0
