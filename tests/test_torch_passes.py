"""vkr_tpu_torch's image-space passes against vkr_tpu's on identical inputs:
hi-Z, the GTAO chain (main, filter, accumulate), deferred shading, TAA, the
BRDF LUT and the sampling helpers.

The inputs are a real G-buffer: two orbit frames of a small colonnade,
rendered by the port on the CPU, then handed as the same numpy arrays to
both packages. Where vkr_tpu's pass reaches a Pallas gather kernel it runs
in interpret mode, as vkr_tpu's own tests run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.passes import downsample as jdown
from vkr_tpu.passes import gtao as jgtao
from vkr_tpu.passes import sampling as jsamp
from vkr_tpu.passes import shading as jshade
from vkr_tpu.passes import ssr as jssr
from vkr_tpu.passes import taa as jtaa
from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
from vkr_tpu_torch.passes import downsample as tdown
from vkr_tpu_torch.passes import gtao as tgtao
from vkr_tpu_torch.passes import sampling as tsamp
from vkr_tpu_torch.passes import shading as tshade
from vkr_tpu_torch.passes import ssr as tssr
from vkr_tpu_torch.passes import taa as ttaa

W, H = 128, 64
FOVY, ZNEAR, ZFAR = None, None, None  # filled from RenderConfig below


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def frames():
    """G-buffers of orbit frames 1 and 2 (numpy), their cameras and the
    config."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, camera_frame
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
        arrays = {k: _np(getattr(g, k)) for k in
                  ("albedo", "normal", "material", "velocity", "depth")}
        arrays["overflow"] = np.int32(0)
        cams = {"view": _np(cam.view), "inv_view": _np(_inv4(cam.view)),
                "prev_inv_view": _np(_inv4(cam.prev_view)),
                "mvp": _np(cam.mvp)}
        out.append((arrays, cams))
    assert (out[0][0]["depth"] < 1.0).mean() > 0.9
    return cfg, out


def _hiz_inputs(gbuf):
    return gbuf["depth"], gbuf["normal"], gbuf["velocity"]


class TestHiZ:
    def test_build_hiz_bitwise_on_a_frame(self, frames):
        _, ((gbuf, _), _) = frames
        want = jdown.build_hiz(*(jnp.asarray(a) for a in _hiz_inputs(gbuf)))
        got = tdown.build_hiz(*(_t(a) for a in _hiz_inputs(gbuf)))
        assert len(got.mips) == len(want.mips)
        for g, w in zip(got.mips, want.mips):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(_np(got.normal_half),
                                      np.asarray(want.normal_half))
        np.testing.assert_array_equal(_np(got.velocity_half),
                                      np.asarray(want.velocity_half))

    def test_tie_priority_bitwise(self):
        """Depths drawn from 3 values, so most quads tie: the selected
        normal/velocity follow the d1 > d2 > d3 > d0 priority."""
        rng = np.random.default_rng(1)
        depth = rng.choice(np.float32([0.25, 0.5, 1.0]), (32, 48))
        normal = rng.random((32, 48, 2)).astype(np.float32)
        velocity = rng.random((32, 48, 2)).astype(np.float32)
        want = jdown.build_hiz(jnp.asarray(depth), jnp.asarray(normal),
                               jnp.asarray(velocity))
        got = tdown.build_hiz(_t(depth), _t(normal), _t(velocity))
        np.testing.assert_array_equal(_np(got.normal_half),
                                      np.asarray(want.normal_half))
        np.testing.assert_array_equal(_np(got.velocity_half),
                                      np.asarray(want.velocity_half))
        for g, w in zip(got.mips, want.mips):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.fixture(scope="module")
def half_res(frames):
    """hi-Z products of both frames (numpy, bitwise equal on both sides)."""
    _, frs = frames
    out = []
    for gbuf, _ in frs:
        hz = tdown.build_hiz(*(_t(a) for a in _hiz_inputs(gbuf)))
        out.append({"depth_half": _np(hz.mips[0]),
                    "normal_half": _np(hz.normal_half),
                    "velocity_half": _np(hz.velocity_half)})
    return out


def _gtao_params(cfg, cams, mod, tensor):
    return mod.GTAOParams(normal_mat=tensor(cams["inv_view"].T),
                          fovy=cfg.camera.fovy, aspect=cfg.aspect,
                          znear=cfg.camera.znear, zfar=cfg.camera.zfar)


def _accum_params(cfg, cams, mod, tensor):
    return mod.GTAOAccumParams(
        inverse_camera=tensor(cams["inv_view"]),
        prev_inverse_camera=tensor(cams["prev_inv_view"]),
        mvp=tensor(cams["mvp"]), fovy=cfg.camera.fovy, aspect=cfg.aspect,
        znear=cfg.camera.znear, zfar=cfg.camera.zfar)


class TestGTAO:
    def test_frame_base_angle_and_pattern(self):
        for i in (0, 1, 7, 12, 4095, 1 << 20):
            want = float(jgtao.frame_base_angle(jnp.int32(i)))
            assert tgtao.frame_base_angle(i) == want, i
        np.testing.assert_array_equal(
            _np(tgtao.gtao_direction_pattern(9, 13, "cpu")),
            np.asarray(jgtao.gtao_direction_pattern(9, 13)))

    @pytest.mark.parametrize("dirs", [1, 2])
    def test_main_window(self, frames, half_res, dirs, monkeypatch):
        """Against vkr_tpu's gtao_main_window with its K4 kernel replaced
        by vkr_tpu's jnp oracle of the same clamp semantics
        (window_gather_reference, one call per step): interpreting K4 at
        the pass's fixed radius 16 compiles for about a minute on a CPU,
        and test_torch_gather.py holds the K4 plain version against the
        interpreted kernel. Tolerance 2e-4: the arc integral runs
        arccos/cos/sin, whose float32 results differ by ulps between XLA
        and PyTorch; arccos's slope near |cos| = 1 turns those into ~1e-5
        of AO."""
        from vkr_tpu.raster import gather_kernel as jgather

        def k4_oracle(img, off_y, off_x, *, radius, interpret, row0):
            assert row0 is None
            return jnp.stack([
                jgather.window_gather_reference(img, off_y[k], off_x[k],
                                                radius)
                for k in range(off_y.shape[0])])

        monkeypatch.setattr(jgather, "window_gather_bilinear_multi",
                            k4_oracle)
        cfg, frs = frames
        _, cams = frs[1]
        hr = half_res[1]
        angle = tgtao.frame_base_angle(2)
        want = np.asarray(jgtao.gtao_main_window(
            jnp.asarray(hr["depth_half"]), jnp.asarray(hr["normal_half"]),
            _gtao_params(cfg, cams, jgtao, jnp.asarray), jnp.float32(angle),
            dirs))
        got = _np(tgtao.gtao_main_window(
            _t(hr["depth_half"]), _t(hr["normal_half"]),
            _gtao_params(cfg, cams, tgtao, _t), angle, dirs))
        assert got.shape == want.shape
        assert want.max() > 0.1  # real occlusion, not an empty frame
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)

    def test_filter(self, frames, half_res):
        """Same arithmetic, summation order and edge padding: 1e-6."""
        cfg, _ = frames
        d = half_res[1]["depth_half"]
        raw = np.random.default_rng(2).random(d.shape).astype(np.float32)
        want = np.asarray(jgtao.gtao_filter(jnp.asarray(d), jnp.asarray(raw),
                                            cfg.camera.znear, cfg.camera.zfar))
        got = _np(tgtao.gtao_filter(_t(d), _t(raw), cfg.camera.znear,
                                    cfg.camera.zfar))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("clear", [False, True])
    def test_accumulate(self, frames, half_res, clear):
        """Both reprojections through K5 (vkr_tpu's interpreted). AO to
        1e-5: the 4x4 camera products may sum in another order, and K5's
        fraction rounding differs by an ulp (test_torch_gather). The
        sample count to 2e-4 (0.05 of one count in 255): it is scaled by
        1 - |linear depth error|, and at the D24 depths of this frame
        (~0.98) linearize_depth multiplies a 1-ulp difference of the
        reprojected NDC z by ~1e4."""
        cfg, frs = frames
        _, cams = frs[1]
        cur, prev = half_res[1], half_res[0]
        rng = np.random.default_rng(3)
        ao = rng.random(cur["depth_half"].shape).astype(np.float32)
        hist = np.stack([rng.random(ao.shape),
                         rng.integers(1, 256, ao.shape) / 255.0],
                        -1).astype(np.float32)
        args = (cur["depth_half"], prev["depth_half"], ao,
                cur["velocity_half"], hist)
        want = np.asarray(jgtao.gtao_accumulate(
            *(jnp.asarray(a) for a in args),
            _accum_params(cfg, cams, jgtao, jnp.asarray), jnp.bool_(clear),
            use_kernel_gather=True, interpret=True))
        got = _np(tgtao.gtao_accumulate(
            *(_t(a) for a in args), _accum_params(cfg, cams, tgtao, _t),
            clear_history=clear))
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                                   atol=2e-4)
        if not clear:
            # the history path was taken on most pixels
            assert (np.abs(got[..., 1] - 1 / 255) > 1e-6).mean() > 0.5


class TestShadingAndTAA:
    def _shade_inputs(self, frames, half_res):
        cfg, frs = frames
        gbuf, cams = frs[1]
        rng = np.random.default_rng(4)
        occ = rng.random(half_res[1]["depth_half"].shape).astype(np.float32)
        refl = (0.2 * rng.random(occ.shape + (3,))).astype(np.float32)
        lut = _np(tssr.preintegrate_brdf(32, num_samples=16, device="cpu"))
        return cfg, gbuf, cams, occ, refl, lut, half_res[1]["depth_half"]

    @pytest.mark.parametrize("show_ao", [False, True])
    def test_deferred_shading(self, frames, half_res, show_ao):
        """3e-6 absolute on colour values below ~1: the same float32
        expression; pow and exp round differently by an ulp."""
        cfg, gbuf, cams, occ, refl, lut, dh = self._shade_inputs(frames,
                                                                 half_res)
        kw = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
                  znear=cfg.camera.znear, zfar=cfg.camera.zfar,
                  min_roughness=0.1, max_roughness=0.9, show_ao=show_ao)
        jg = JGBuffer(**{k: jnp.asarray(v) for k, v in gbuf.items()})
        want = np.asarray(jshade.deferred_shading(
            jg, jshade.ShadingParams(inverse_camera=jnp.asarray(
                cams["inv_view"]), **kw),
            occlusion=jnp.asarray(occ), reflections=jnp.asarray(refl),
            brdf_lut=jnp.asarray(lut), depth_half=jnp.asarray(dh)))
        from vkr_tpu_torch.passes.gbuffer import GBuffer

        tg = GBuffer(**{k: _t(v) for k, v in gbuf.items()})
        got = _np(tshade.deferred_shading(
            tg, tshade.ShadingParams(inverse_camera=_t(cams["inv_view"]),
                                     **kw),
            occlusion=_t(occ), reflections=_t(refl), brdf_lut=_t(lut),
            depth_half=_t(dh)))
        assert got.shape == (H, W, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)

    def test_taa_resolve(self, frames):
        """vkr_tpu's resolve takes its six history taps through bilinear
        gathers at pixel uv + velocity (its dense path): interpreting K6 at
        the pass's fixed radius 16 takes minutes to compile on a CPU, and
        the K6 plain version is held against the interpreted kernel in
        test_torch_gather. The two paths differ only by K6's +-16 px clamp,
        which no offset of this frame reaches (asserted). 1e-5: the dense
        path rounds the tap position through uv, the port through a pixel
        offset, an ulp or so of the fraction."""
        cfg, frs = frames
        (prev, _), (cur, cams) = frs
        vel_px = np.abs(cur["velocity"] * np.float32([W, H]))
        assert vel_px.max() + 1 < 16
        rng = np.random.default_rng(5)
        hist = rng.random((H, W, 3)).astype(np.float32)
        color = rng.random((H, W, 3)).astype(np.float32)
        kw = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
                  znear=cfg.camera.znear, zfar=cfg.camera.zfar)
        args = (hist, prev["depth"], cur["depth"], cur["velocity"], color)
        want = np.asarray(jtaa.taa_resolve(
            *(jnp.asarray(a) for a in args),
            jtaa.TAAParams(inverse_camera=jnp.asarray(cams["inv_view"]),
                           prev_inverse_camera=jnp.asarray(
                               cams["prev_inv_view"]), **kw),
            use_kernel_gather=False))
        got = _np(ttaa.taa_resolve(
            *(_t(a) for a in args),
            ttaa.TAAParams(inverse_camera=_t(cams["inv_view"]),
                           prev_inverse_camera=_t(cams["prev_inv_view"]),
                           **kw)))
        # blended pixels differ from the current colour: most reproject
        assert (np.abs(got - color).max(-1) > 1e-3).mean() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_preintegrate_brdf_64():
    """64x64 LUT, 128 samples: float32 sums of the same terms in the same
    order; sqrt/pow may differ by an ulp per sample, so 2e-6."""
    want = np.asarray(jssr.preintegrate_brdf(64))
    got = _np(tssr.preintegrate_brdf(64, device="cpu"))
    assert got.shape == want.shape == (64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


class TestSampling:
    def test_screen_uv_and_bilinear_sample(self):
        rng = np.random.default_rng(6)
        img = rng.random((12, 20, 3)).astype(np.float32)
        uv = rng.uniform(-0.2, 1.2, (7, 9, 2)).astype(np.float32)
        np.testing.assert_array_equal(_np(tsamp.screen_uv_grid(12, 20, "cpu")),
                                      np.asarray(jsamp.screen_uv_grid(12, 20)))
        want = np.asarray(jsamp.bilinear_sample(jnp.asarray(img),
                                                jnp.asarray(uv)))
        got = _np(tsamp.bilinear_sample(_t(img), _t(uv)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("offset", [(0, 0), (1, 0), (0, 1), (1, 1)])
    def test_upsample_half_bilinear(self, offset):
        img = np.random.default_rng(7).random((6, 10, 2)).astype(np.float32)
        want = np.asarray(jsamp.upsample_half_bilinear(jnp.asarray(img),
                                                       offset))
        got = _np(tsamp.upsample_half_bilinear(_t(img), offset))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_quad_pack_and_fetch(self):
        rng = np.random.default_rng(8)
        img = rng.random((16, 16, 2)).astype(np.float32)
        uv = rng.uniform(-0.1, 1.1, (5, 7, 2)).astype(np.float32)
        qj = jsamp.quad_pack(jnp.asarray(img))
        qt = tsamp.quad_pack(_t(img))
        np.testing.assert_array_equal(_np(qt), np.asarray(qj))
        want = np.asarray(jsamp.bilinear_from_quad(qj, 2, jnp.asarray(uv)))
        got = _np(tsamp.bilinear_from_quad(qt, 2, _t(uv)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
