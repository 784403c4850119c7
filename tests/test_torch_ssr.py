"""The port's SSR passes, their LUTs, the hi-Z march (the plain version of
the CUDA kernel that replaces vkr_tpu's K2+K3) and the MIS GTAO main pass,
each against vkr_tpu's function on the same inputs.

The G-buffer is the port's: the 24-column colonnade hall (the bench's
geometry at tessellation 4) at 256x128, orbit frame 1 after frame 0. It
is held against vkr_tpu's Pallas-path G-buffer in test_torch_raster.py,
and here both sides start from this one set of arrays.
vkr_tpu runs jitted, as in its frame, with its march's no-drop oracle
(`_hierarchical_march(..., compact_frac=0.0)`): the port drops no ray."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkr_tpu.passes.ssr as jssr
from vkr_tpu_torch.passes import ssr as tssr
from vkr_tpu_torch.passes import ssr_march as tmarch

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

W, H = 256, 128
LUT = 64
MAX_IT = 80


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def no_drop():
    """vkr_tpu's march without compaction drops (test-only patch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        yield


@pytest.fixture(scope="module")
def hall():
    """Frame 1 of the bench orbit (and frame 0's half-res depth) through
    the port's G-buffer and hi-Z, as numpy arrays, with the frame's SSR
    parameters for both packages."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=32), "cpu")
    out = {}
    for i in (0, 1):
        cam = camera_frame(cfg, bench_orbit_view(i),
                           bench_orbit_view(max(i - 1, 0)), i, "cpu")
        g = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter,
                           width=W, height=H)
        hiz = build_hiz(g.depth, g.normal, g.velocity)
        out[i] = dict(g=g, hiz=hiz, cam=cam)
    g, hiz, cam = out[1]["g"], out[1]["hiz"], out[1]["cam"]
    nm = _normal_mat4(cam.view).numpy()
    p = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
             znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    return dict(
        mips=[m.numpy() for m in hiz.mips], normal_half=hiz.normal_half.numpy(),
        velocity_half=hiz.velocity_half.numpy(),
        prev_depth_half=out[0]["hiz"].mips[0].numpy(),
        albedo=g.albedo.numpy(), material=g.material.numpy(), nm=nm,
        inv_view=_inv4(cam.view).numpy(),
        prev_inv_view=_inv4(cam.prev_view).numpy(),
        jparams=jssr.SSRParams(normal_mat=jnp.asarray(nm), **p),
        tparams=tssr.SSRParams(normal_mat=torch.from_numpy(nm), **p), p=p)


@pytest.fixture(scope="module")
def luts():
    from vkr_tpu.mathlib.brdf import halton23_table

    pdf = np.asarray(jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT))
    return dict(pdf=pdf, halton=halton23_table(jssr.HALTON_SEQ_SIZE))


@pytest.fixture(scope="module")
def traced(hall, luts, no_drop):
    """vkr_tpu's jitted ssr_trace and the port's on the same inputs."""
    pyr = jssr.pack_pyramid([jnp.asarray(m) for m in hall["mips"]])

    def jtrace(flat, normal_half, material, pdf):
        return jssr.ssr_trace(pyr._replace(flat=flat), normal_half,
                              material, pdf, hall["jparams"],
                              jnp.asarray(1), jnp.asarray(luts["halton"]),
                              max_iterations=MAX_IT)

    want = jax.jit(jtrace)(pyr.flat, hall["normal_half"], hall["material"],
                           luts["pdf"])
    got = tssr.ssr_trace(
        tssr.pack_pyramid([_t(m) for m in hall["mips"]]),
        _t(hall["normal_half"]), _t(hall["material"]), _t(luts["pdf"]),
        hall["tparams"], 1, _t(luts["halton"]), MAX_IT)
    return ([np.asarray(a) for a in want], [a.numpy() for a in got])


# ---------------------------------------------------------------- LUTs

def test_preintegrate_pdf_64():
    """2,000 float32 steps summed in the same order. The integrand
    (1-t)L / (1 + t^2 - L^2/2)^2 is near-singular where its denominator
    nears 0, and there an ulp of the denominator moves one term by orders
    of magnitude. vkr_tpu's jit contracts t, L and the denominator into
    fmas, and the port rounds those steps once as the jit does. So every
    texel is finite on both sides, the bulk is held at 1e-6 relative
    (median) and the p99 at 5e-3, and at least 99.9% of the texels are
    bit-equal."""
    want = np.asarray(jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT))
    got = tssr.preintegrate_pdf(LUT, device="cpu").numpy()
    assert got.shape == want.shape == (LUT, LUT)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.median(rel) <= 1e-6 and np.percentile(rel, 99) <= 5e-3
    assert (got == want).mean() >= 0.999


def test_sample_ggx_dir_pdf(luts):
    """Random front-facing (w0, n, l) and roughness through both: the same
    cross products and one bilinear LUT tap. Where the tap falls on the
    LUT's steep edge an ulp of the coordinate moves it by up to 4e-5
    relative, so 1e-4."""
    rng = np.random.default_rng(7)

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)
                ).astype(np.float32)

    n = unit(rng.normal(size=(32, 32, 3)) + [0, 0, 2])
    w0 = unit(rng.normal(size=(32, 32, 3)) + [0, 0, 2])
    l = unit(rng.normal(size=(32, 32, 3)) + [0, 0, 2])
    alpha = (rng.random((32, 32)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jssr.sample_ggx_dir_pdf)(
        luts["pdf"], w0, n, l, alpha))
    got = tssr.sample_ggx_dir_pdf(*(_t(a) for a in (luts["pdf"], w0, n, l,
                                                    alpha))).numpy()
    assert np.isfinite(got).all() and (got > 0).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------- march

def _mirror_scene(size):
    """tests/test_ssr_march.py's mirror floor + back wall and its mirror
    rays (roughness 0), built by vkr_tpu."""
    from vkr_tpu.mathlib import encode_normal, look_at, perspective
    from vkr_tpu.mathlib.octahedral import decode_normal
    from vkr_tpu.mathlib.projection import (project_view_vec,
                                            reconstruct_view_vec)
    from vkr_tpu.mathlib.transforms import normal_matrix
    from vkr_tpu.passes.downsample import build_hiz
    from vkr_tpu.passes.sampling import screen_uv_grid
    from vkr_tpu.raster import rasterize

    view = look_at((0, 1.0, -2.0), (0, 0.8, 1.0), (0, -1, 0))
    vp = perspective(np.radians(60), 1.0, 0.05, 80.0) @ view
    world = np.array(
        [[-4, 0, -4, 1], [4, 0, -4, 1], [4, 0, 3, 1], [-4, 0, 3, 1],
         [-4, 0, 3, 1], [4, 0, 3, 1], [4, 3, 3, 1], [-4, 3, 3, 1]],
        np.float32)
    idx = jnp.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                      jnp.int32)
    vis = rasterize(jnp.asarray(world @ vp.T), idx, width=size,
                    height=size, use_pallas=False)
    src = np.asarray(vis.src)[np.maximum(np.asarray(vis.tri_id), 0)]
    nrm = np.where((src >= 2)[..., None], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0])
    hiz = build_hiz(vis.depth, encode_normal(jnp.asarray(nrm)),
                    jnp.zeros((size, size, 2)))
    params = jssr.SSRParams(normal_mat=jnp.asarray(normal_matrix(view)),
                            fovy=np.radians(60), aspect=1.0, znear=0.05,
                            zfar=80.0)
    pyr = jssr.pack_pyramid(hiz.mips)
    h, w = pyr.heights[0], pyr.widths[0]
    uv = screen_uv_grid(h, w)
    depth = pyr.flat[: h * w].reshape(h, w)
    nm = jnp.asarray(params.normal_mat)
    n = decode_normal(hiz.normal_half) @ nm[:3, :3].T
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    view_vec = reconstruct_view_vec(uv, depth, params.fovy, params.aspect,
                                    params.znear, params.zfar)
    r = view_vec - 2.0 * (view_vec * n).sum(-1, keepdims=True) * n
    start = project_view_vec(view_vec + 0.001 * n, params.fovy,
                             params.aspect, params.znear, params.zfar)
    start = start.at[..., 2].add(-0.0001)
    d = project_view_vec(view_vec + r, params.fovy, params.aspect,
                         params.znear, params.zfar) - start
    d = d * ((1.0 - start[..., 2]) / d[..., 2])[..., None]
    w0 = -view_vec / jnp.linalg.norm(view_vec, axis=-1, keepdims=True)
    rays = [np.asarray(a) for a in (start, d, view_vec, w0)]
    return pyr, [np.asarray(m) for m in hiz.mips], rays, params, view, vp


def _march_both(pyr, mips, rays, params, max_it):
    want = jax.jit(lambda f, *r: jssr._hierarchical_march(
        pyr._replace(flat=f), *r, params, max_it, compact_frac=0.0))(
            pyr.flat, *rays)
    tp = tssr.SSRParams(normal_mat=_t(params.normal_mat), fovy=params.fovy,
                        aspect=params.aspect, znear=params.znear,
                        zfar=params.zfar)
    got = tmarch.hierarchical_march_reference(
        [_t(m) for m in mips], *(_t(r) for r in rays), tp, max_it)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _trajectory(want, got, max_it, size):
    """(validity agreement, p99 hit uv error in texels over rays valid in
    both, p99 |hor difference|) — experiments/validate_march.py's
    metrics."""
    (pw, hw, iw), (pg, hg, ig) = want, got
    vw, vg = iw <= max_it, ig <= max_it
    both = vw & vg
    assert both.sum() > 100
    hit = np.abs(pw[..., :2] - pg[..., :2])[both].max(-1) * size
    out = ((vw == vg).mean(), np.percentile(hit, 99),
           np.percentile(np.abs(hw - hg), 99))
    print("march: validity agreement %.6f, hit p99 %.3g texel, horizon p99 "
          "%.3g" % out)
    return out


class TestMarch:
    """The plain march against vkr_tpu's no-drop oracle. Not bitwise:
    XLA's jit contracts the march's mul+add pairs into fmas and the port
    rounds them apart, so a knife-edge ray may step to the other side of
    a texel. Held by trajectory: validity agreement >= 0.999, hit error
    p99 < 1 texel, horizon p99 < 1e-3."""

    def test_mirror_scene(self):
        pyr, mips, rays, params, _, _ = _mirror_scene(64)
        want, got = _march_both(pyr, mips, rays, params, 48)
        agree, hit_p99, hor_p99 = _trajectory(want, got, 48, 32)
        assert agree >= 0.999 and hit_p99 < 1.0 and hor_p99 < 1e-3

    def test_colonnade(self, hall, luts):
        """The frame's own rays: vkr_tpu's ray setup on the hall G-buffer
        (so both marches take identical rays), 80 iterations."""
        pyr = jssr.pack_pyramid([jnp.asarray(m) for m in hall["mips"]])
        h, w = pyr.heights[0], pyr.widths[0]
        from vkr_tpu.passes.sampling import (downsample_full_to_half,
                                             screen_uv_grid)

        def setup(flat, normal_half, material):
            rough = downsample_full_to_half(material)[..., 1] ** 2
            out = jssr._reflection_ray_setup(
                screen_uv_grid(h, w), flat[: h * w].reshape(h, w),
                normal_half, rough, hall["jparams"], jnp.asarray(1),
                jnp.asarray(luts["halton"]))
            return out[4], out[5], out[0], out[1]

        rays = [np.asarray(a) for a in jax.jit(setup)(
            pyr.flat, hall["normal_half"], hall["material"])]
        want, got = _march_both(pyr, hall["mips"], rays, hall["jparams"],
                                MAX_IT)
        agree, hit_p99, hor_p99 = _trajectory(want, got, MAX_IT, w)
        assert agree >= 0.999 and hit_p99 < 1.0 and hor_p99 < 1e-3

    def test_mirror_floor_golden(self):
        """Analytic golden (tests/test_ssr_march.py:137-194), independent of
        both marches: a floor pixel's mirror ray hits the wall z=3 where
        the camera mirrored across y=0 sees the floor point."""
        from vkr_tpu.mathlib.projection import reconstruct_view_vec
        from vkr_tpu.passes.sampling import screen_uv_grid

        pyr, mips, rays, params, view, vp = _mirror_scene(128)
        tp = tssr.SSRParams(normal_mat=_t(params.normal_mat),
                            fovy=params.fovy, aspect=params.aspect,
                            znear=params.znear, zfar=params.zfar)
        pos, _, it = (a.numpy() for a in tmarch.hierarchical_march(
            [_t(m) for m in mips], *(_t(r) for r in rays), tp, 64))
        valid = it <= 64
        inv_view = np.linalg.inv(np.asarray(view))
        cam_pos = inv_view[:3, 3]
        h, w = pos.shape[:2]
        vv = np.asarray(reconstruct_view_vec(
            screen_uv_grid(h, w), jnp.asarray(mips[0]), params.fovy,
            params.aspect, params.znear, params.zfar))
        wp = vv @ inv_view[:3, :3].T + cam_pos
        m = ((np.abs(wp[..., 1]) < 0.05) & (mips[0] < 1.0)
             & (wp[..., 2] > -1.0) & (wp[..., 2] < 2.0) & valid)
        cam_m = cam_pos * np.array([1, -1, 1])
        dirs = wp - cam_m
        hit_w = cam_m + ((3.0 - cam_m[2]) / dirs[..., 2])[..., None] * dirs
        m &= (hit_w[..., 1] > 0.05) & (hit_w[..., 1] < 2.9)
        assert m.sum() > 100, m.sum()
        hp4 = np.concatenate([hit_w, np.ones(hit_w.shape[:-1] + (1,))],
                             -1) @ np.asarray(vp).T
        exp_uv = 0.5 * hp4[..., :2] / hp4[..., 3:4] + 0.5
        err = np.abs(pos[..., :2] - exp_uv)[m].max(-1)
        assert np.percentile(err, 80) < 2.0 / w
        assert np.median(err) < 1.0 / w

    def test_wrapper_takes_plain_version_on_cpu(self):
        from vkr_tpu_torch import kernels

        pyr, mips, rays, params, _, _ = _mirror_scene(64)
        tp = tssr.SSRParams(normal_mat=_t(params.normal_mat),
                            fovy=params.fovy, aspect=params.aspect,
                            znear=params.znear, zfar=params.zfar)
        before = kernels.LAUNCHES["hierarchical_march"]
        a = tmarch.hierarchical_march([_t(m) for m in mips],
                                      *(_t(r) for r in rays), tp, 48)
        b = tmarch.hierarchical_march_reference(
            tssr.pack_pyramid([_t(m) for m in mips]),
            *(_t(r) for r in rays), tp, 48)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert a[2].dtype == torch.int32
        assert kernels.LAUNCHES["hierarchical_march"] == before


# ------------------------------------------------------- flat pyramid

def test_fetch_pyramid_bit_equal():
    """fetch_pyramid against vkr_tpu's on a seeded 5-level pyramid of
    37x53: every mip (and -1 and 5, which vkr_tpu's where-chain reads as
    level 0), x and y from below 0 to past each level's edge."""
    rng = np.random.default_rng(17)
    shapes = [(37, 53), (19, 27), (10, 14), (5, 7), (3, 4)]
    mips = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    n = 4096
    mip = rng.integers(-1, 6, n).astype(np.int32)
    x = rng.integers(-20, 80, n).astype(np.int32)
    y = rng.integers(-20, 60, n).astype(np.int32)
    want = np.asarray(jssr.fetch_pyramid(
        jssr.pack_pyramid([jnp.asarray(m) for m in mips]),
        jnp.asarray(mip), jnp.asarray(x), jnp.asarray(y)))
    got = tssr.fetch_pyramid(tssr.pack_pyramid([_t(m) for m in mips]),
                             _t(mip), _t(x), _t(y))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    for level in range(-1, 6):  # each mip and both edges were drawn
        at = mip == level
        assert (x[at] < 0).any() and (y[at] < 0).any()
    assert (x >= 53).any() and (y >= 37).any()


def test_max_t_is_vkr_tpus():
    assert tssr.MAX_T == jssr.MAX_T
    assert np.float32(tssr.MAX_T) == np.float32(jssr.MAX_T)
    assert tssr.MAX_T is tmarch.MAX_T


# ------------------------------------------------------- SSR passes

def test_halton_index_share():
    """The per-pixel halton row of vkr_tpu's jitted trace and the port's at
    the trace size. sin's last ulp, times 43758.5453, decides the row;
    the port pins the dot (one fma) and sin (float64), and what is left
    is XLA's float32 sin: 0.22% of the rows differ (ROADMAP queue 3)."""
    from vkr_tpu.passes.sampling import screen_uv_grid as juv
    from vkr_tpu_torch.passes.sampling import screen_uv_grid as tuv

    h, w = H // 2, W // 2
    want = np.asarray(jax.jit(lambda: (jssr._shader_rand(juv(h, w))
                                       * 128).astype(jnp.uint32))())
    got = tssr._halton_index(tuv(h, w, "cpu"), 0).numpy()
    share = (want != got).mean()
    print(f"halton rows differing at {w}x{h}: {share:.4%}")
    assert share <= 0.005


def test_ssr_trace(traced):
    """Validity agreement >= 0.999 and the hit uv of rays valid in both
    within one texel at p99. A pixel whose halton row differs traces
    another ray, and the occlusion estimate of a grazing ray is
    ill-conditioned, so the occlusion channel is held on 99% of the
    pixels."""
    (rw, ow), (rg, og) = traced
    vw, vg = rw[..., 3] != 1.0, rg[..., 3] != 1.0
    assert vw.mean() > 0.05
    assert (vw == vg).mean() >= 0.999
    both = vw & vg
    hit = np.abs(rw[..., :2] - rg[..., :2])[both].max(-1) * (W // 2)
    assert np.percentile(hit, 99) < 1.0
    close = np.abs(ow[..., 0] - og[..., 0]) <= 1e-3
    assert close.mean() >= 0.99
    assert np.isfinite(og).all()


def test_ssr_filter(hall, traced):
    """Identical rays in (vkr_tpu's): the same five taps and weights in
    float32. vkr_tpu's jit contracts the BRDF weight's dot products into
    fmas, and the weights are divided by their sum: 1e-5 + 1e-3
    relative."""
    rays = traced[0][0]
    want = np.asarray(jax.jit(lambda *a: jssr.ssr_filter(
        *a, hall["jparams"]))(rays, hall["mips"][0], hall["albedo"],
                              hall["normal_half"], hall["material"]))
    got = tssr.ssr_filter(_t(rays), _t(hall["mips"][0]), _t(hall["albedo"]),
                          _t(hall["normal_half"]), _t(hall["material"]),
                          hall["tparams"]).numpy()
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
def test_ssr_blur(hall, traced, accumulate, monkeypatch):
    """The 23x23 blur and the history blend on identical inputs (random
    history). vkr_tpu's reprojection runs through its jnp window-gather
    oracle, the function its K5 computes, so both sides clamp the offset
    to +-16 px. R2's plain version adds the 529 taps one by one in
    vkr_tpu's order (ssr_blur_kernel.ssr_blur_reference); the two differ
    by their expf and float32 roundings only, 1.2e-7 at most here (the
    row sums this replaced read 1.5e-7), held to 1e-5."""
    import vkr_tpu.raster.gather_kernel as jgather

    monkeypatch.setattr(
        jgather, "window_gather_bilinear",
        lambda img, off_y, off_x, radius=16, interpret=False, row0=None:
        jgather.window_gather_reference(img, off_y, off_x, radius))
    refl = np.asarray(jax.jit(lambda *a: jssr.ssr_filter(
        *a, hall["jparams"]))(traced[0][0], hall["mips"][0], hall["albedo"],
                              hall["normal_half"], hall["material"]))
    hist = (np.random.default_rng(3).random(refl.shape) * 0.5
            ).astype(np.float32)
    kw = dict(fovy=hall["p"]["fovy"], aspect=hall["p"]["aspect"],
              znear=hall["p"]["znear"], zfar=hall["p"]["zfar"],
              accumulate=accumulate)
    jp = jssr.SSRBlurParams(inverse_camera=jnp.asarray(hall["inv_view"]),
                            prev_inverse_camera=jnp.asarray(
                                hall["prev_inv_view"]), **kw)
    args = (refl, hall["mips"][0], hall["normal_half"], hall["material"],
            hist, hall["velocity_half"], hall["prev_depth_half"])
    want = np.asarray(jax.jit(lambda *a: jssr.ssr_blur(
        *a, jp, use_kernel_gather=True))(*args))
    tp = tssr.SSRBlurParams(inverse_camera=_t(hall["inv_view"]),
                            prev_inverse_camera=_t(hall["prev_inv_view"]),
                            **kw)
    got = tssr.ssr_blur(*(_t(a) for a in args), tp).numpy()
    # with accumulate most pixels blend the history: the two sides must
    # also agree on which
    assert np.abs(got - hist).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _blur_pass_inputs(h=24, w=32, seed=5):
    """The blur pass's inputs for a flat patch: depth near 0.5, normals
    near +z, roughness 0 (sigma 0.4, radius 1) but for a 16x16 block of
    roughness 1 (sigma 4, radius 11) at full-res (16, 16); reflections in
    [0, 1) with +inf at (12, 20) channel 1 and NaN at (5, 5) channel 0;
    no motion."""
    rng = np.random.default_rng(seed)
    refl = rng.random((h, w, 3)).astype(np.float32)
    refl[12, 20, 1] = np.inf
    refl[5, 5, 0] = np.nan
    depth = (0.5 + 1e-6 * rng.random((h, w))).astype(np.float32)
    normal = (0.5 + 0.01 * rng.random((h, w, 2))).astype(np.float32)
    material = np.zeros((2 * h, 2 * w, 4), np.float32)
    material[16:32, 16:32, 1] = 1.0
    zeros = np.zeros((h, w, 3), np.float32)
    return (refl, depth, normal, material, zeros,
            np.zeros((h, w, 2), np.float32), depth)


def test_ssr_blur_nonfinite_reflection():
    """A non-finite reflection inside a pixel's 23x23 window but outside
    its radius still reaches its colour: the tap's weight there is 0 and
    inf x 0 and NaN x 0 are NaN, in vkr_tpu's fori_loop as in the port.
    So the channel of an inf is +inf within the radius of the pixels
    around it (a positive weight) and NaN on the rest of their window; a
    NaN makes its channel NaN on its whole window; every other value is
    finite. The port's pass (R2's plain version, no history) holds
    vkr_tpu's pass there exactly and elsewhere to 1e-5."""
    args = _blur_pass_inputs()
    eye = np.eye(4, dtype=np.float32)
    kw = dict(fovy=1.0, aspect=4.0 / 3.0, znear=0.05, zfar=80.0,
              accumulate=False)
    want = np.asarray(jssr.ssr_blur(
        *(jnp.asarray(a) for a in args),
        jssr.SSRBlurParams(inverse_camera=jnp.asarray(eye),
                           prev_inverse_camera=jnp.asarray(eye), **kw),
        use_kernel_gather=False))
    got = tssr.ssr_blur(*(_t(a) for a in args), tssr.SSRBlurParams(
        inverse_camera=_t(eye), prev_inverse_camera=_t(eye), **kw)).numpy()
    h, w = args[1].shape
    y, x = np.mgrid[0:h, 0:w]
    radius = np.where((y >= 8) & (y < 16) & (x >= 8) & (x < 16), 11, 1)

    def window(cy, cx):
        return (np.abs(y - cy) <= 11) & (np.abs(x - cx) <= 11)

    def inside(cy, cx):
        return (np.abs(y - cy) <= radius) & (np.abs(x - cx) <= radius)

    inf_win, nan_win = window(12, 20), window(5, 5)
    assert np.array_equal(np.isposinf(got[..., 1]), inside(12, 20))
    assert np.array_equal(np.isnan(got[..., 1]),
                          inf_win & ~inside(12, 20))
    assert np.array_equal(np.isnan(got[..., 0]), nan_win)
    assert np.isfinite(got[..., 2]).all()
    assert 0 < inside(12, 20).sum() < inf_win.sum()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


def test_ssr_blur_wrapper_on_cpu(monkeypatch):
    """R2's wrapper on CPU tensors is its plain version (bit for bit, no
    CUDA library asked for, kernels.LAUNCHES untouched), whole and as a
    band; its kernel path's checks refuse a wrong shape, a float64 plane,
    a non-contiguous plane, rows beyond the frame, and a CPU tensor."""
    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.passes import ssr_blur_kernel as bk

    def no_library(name):
        raise AssertionError(f"a CPU call asked for the {name} library")

    monkeypatch.setattr(kernels, "library", no_library)
    rng = np.random.default_rng(11)
    h, w = 20, 28
    refl = _t(rng.random((h, w, 3)).astype(np.float32))
    depth = _t((0.5 + 1e-5 * rng.random((h, w))).astype(np.float32))
    normal = _t(np.tile(np.float32([0.0, 0.0, 1.0]), (h, w, 1)))
    sigma = _t((0.4 + 3.6 * rng.random((h, w))).astype(np.float32))
    before = dict(kernels.LAUNCHES)
    whole = bk.ssr_blur(refl, depth, normal, sigma)
    assert torch.equal(whole, bk.ssr_blur_reference(refl, depth, normal,
                                                    sigma))
    band = bk.ssr_blur(refl, depth, normal, sigma[5:12], row0=5)
    assert torch.equal(band, whole[5:12])
    assert dict(kernels.LAUNCHES) == before
    assert torch.isfinite(whole).all() and whole.shape == (h, w, 3)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        bk._check(refl, depth, normal, sigma[5:12], 5)
    for bad, match in (
            ((refl[:, :-1].contiguous(), depth, normal, sigma, 0), "want"),
            ((refl, depth.double(), normal, sigma, 0), "float32"),
            ((refl, depth, normal.transpose(0, 1).contiguous()
              .transpose(0, 1), sigma, 0), "contiguous"),
            ((refl, depth, normal, sigma[:8], 15), "rows"),
            ((refl, depth, normal, sigma[:8], -1), "rows")):
        with pytest.raises(ValueError, match=match):
            bk._check(*bad)


@pytest.mark.parametrize("reflections_only", [False, True])
def test_gtao_main_mis(hall, luts, traced, reflections_only):
    """The MIS main pass on the same SSR occlusion (vkr_tpu's), vkr_tpu with
    its bilinear_sample loop (use_kernel=False), the port with its 16 taps
    through K4's plain version: radius <= 16 px, so K4's clamp never binds
    and the two differ by the tap position's rounding, as the single-
    strategy pass (test_torch_passes.py): 2e-4. The GGX pdf of the
    sampled direction is a tap of the near-singular PDF LUT (see
    test_preintegrate_pdf_64) and scales the MIS weight, hence 3e-3
    relative as well."""
    import vkr_tpu.passes.gtao as jg
    from vkr_tpu_torch.passes import gtao as tg

    occ = traced[0][1]
    jp = jg.GTAOParams(normal_mat=jnp.asarray(hall["nm"]), **hall["p"])
    tp = tg.GTAOParams(normal_mat=_t(hall["nm"]), **hall["p"])
    args = (hall["mips"][0], hall["normal_half"], hall["material"],
            luts["pdf"], occ)
    want = np.asarray(jax.jit(lambda *a: jg.gtao_main_mis(
        *a, jp, jg.frame_base_angle(jnp.asarray(1)),
        reflections_only=reflections_only, use_kernel=False))(*args))
    got = tg.gtao_main_mis(*(_t(a) for a in args), tp, tg.frame_base_angle(1),
                           reflections_only=reflections_only).numpy()
    assert np.isfinite(got).all() and got.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=2e-4)


@pytest.mark.parametrize("entry", ["build_ssr_resources", "preintegrate_brdf",
                                   "preintegrate_pdf"])
def test_lut_builders_default_to_the_card(entry):
    """The start-up LUT builders put their tensors on the card unless the
    caller asks for another device: called without one here, where torch
    has no CUDA, they raise instead of falling back to the CPU."""
    import inspect

    from vkr_tpu_torch import frame

    fn = getattr(frame if entry == "build_ssr_resources" else tssr, entry)
    assert inspect.signature(fn).parameters["device"].default == \
        torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            fn(8)
