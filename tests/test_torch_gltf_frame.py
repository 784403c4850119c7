"""The slice as a whole on the CPU: a glTF scene written to disk, loaded
with load_scene(native_sizes=True), uploaded and rendered with
RenderConfig(trilinear_textures=True) (SSR on, MIS GTAO, TAA) at 256x128,
against vkr_tpu on the same file.

The G-buffer is held to vkr_tpu's production path (its Pallas kernel
interpreted, run eagerly: one interpret-mode compile of each K1 shape is
most of this file's time). The rest of the frame is held to vkr_tpu's
oracle shade_frame on the port's G-buffer, as test_torch_ssr_frame.py
holds the default frame (its march patched to drop no ray, as the port's
does). The scene is test_torch_gltf.py's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gltf import TEX_SIZE, _cameras, colonnade_gltf, native_lib  # noqa: F401

torch.set_num_threads(1)

W, H = 256, 128
N_FRAMES = 3
LUT_SIZE = 64


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    return colonnade_gltf(tmp_path_factory.mktemp("gltf"))


@pytest.fixture(scope="module")
def gbuffer_pair(gltf_path, native_lib):  # noqa: F811
    """The loaded scene's frame-2 G-buffer with trilinear textures through
    vkr_tpu's production path (corner tables, its Pallas kernel
    interpreted, run eagerly as test_torch_raster.py's gbuffer_pair runs
    it) and the port's; and the port's with trilinear off."""
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.scene import load_scene as j_load
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.scene import load_scene

    cfg, cam = _cameras(2, W, H)
    kw = dict(width=W, height=H, quantize=True,
              mask_peel_layers=cfg.raster.mask_peel_layers)
    jscene = j_upload(j_load(gltf_path, tex_size=TEX_SIZE,
                             native_sizes=True))
    jg = j_render(jscene, cam.mvp, cam.prev_mvp, cam.jitter,
                  use_pallas=True, interpret=True, trilinear=True, **kw)
    scene = upload_scene(load_scene(gltf_path, tex_size=TEX_SIZE,
                                    native_sizes=True), "cpu")
    args = [torch.from_numpy(np.array(a)) for a in
            (cam.mvp, cam.prev_mvp, cam.jitter)]
    tg = render_gbuffer(scene, *args, trilinear=True, **kw)
    bilinear = render_gbuffer(scene, *args, **kw)
    return scene, jscene, jg, tg, bilinear


class TestGbuffer:
    @pytest.mark.parametrize("channel", ["albedo", "normal", "material",
                                         "velocity", "depth"])
    def test_channel_psnr(self, gbuffer_pair, channel):
        """The repo's parity bar (BASELINE.json, tools/parity.py)."""
        _, _, jg, tg, _ = gbuffer_pair
        got = getattr(tg, channel).numpy()
        want = np.asarray(getattr(jg, channel))
        assert got.shape == want.shape
        value = psnr(got, want)
        print(f"{channel}: {value:.2f} dB")
        assert value >= 40.0, channel

    def test_depth_equal_on_covered_pixels(self, gbuffer_pair):
        _, _, jg, tg, _ = gbuffer_pair
        got, want = tg.depth.numpy(), np.asarray(jg.depth)
        covered = (got < 1.0) | (want < 1.0)
        assert covered.mean() > 0.9
        assert (got[covered] == want[covered]).mean() >= 0.999
        assert int(tg.overflow) == 0 == int(jg.overflow)

    def test_native_pairs_and_trilinear_taken(self, gbuffer_pair):
        """Every material pairs (a CLAMP pair of 32x8, a leaf without MR),
        so vkr_tpu packs pair rows and trilinear moves the albedo."""
        scene, jscene, _, tg, bilinear = gbuffer_pair
        assert scene.tex.paired and jscene.tex.pair_quad is not None
        assert scene.tex.base_size is None
        changed = (tg.albedo != bilinear.albedo).any(-1).float().mean()
        assert float(changed) > 0.05
        torch.testing.assert_close(tg.depth, bilinear.depth, rtol=0, atol=0)


def test_legacy_gbuffer(gbuffer_pair):
    """gbuf_opaque (render_gbuffer_legacy): the unjittered raster with prev
    == cur projection and the velocity plane zero, against vkr_tpu's
    (interpreted Pallas path, the shapes gbuffer_pair compiled)."""
    from vkr_tpu.passes.gbuffer import render_gbuffer_legacy as j_legacy
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer_legacy

    scene, jscene, _, _, _ = gbuffer_pair
    _, cam = _cameras(2, W, H)
    kw = dict(width=W, height=H, quantize=True, trilinear=True)
    jg = j_legacy(jscene, cam.mvp, use_pallas=True, interpret=True, **kw)
    tg = render_gbuffer_legacy(scene, torch.from_numpy(np.array(cam.mvp)),
                               **kw)
    assert not tg.velocity.any() and not np.asarray(jg.velocity).any()
    for channel in ("albedo", "normal", "material", "depth"):
        value = psnr(getattr(tg, channel).numpy(),
                     np.asarray(getattr(jg, channel)))
        assert value >= 40.0, (channel, value)
    assert float((tg.depth < 1.0).float().mean()) > 0.9


CHANNELS = ["ssr", "ao", "color"]


@pytest.fixture(scope="module")
def frames(gltf_path):
    """Per frame, vkr_tpu's oracle chain and the port's render_frame on the
    port's G-buffer and the same cameras."""
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.convert import ssr_resources_from_numpy
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.scene import load_scene

    jcfg = JConfig(width=W, height=H, trilinear_textures=True)
    cfg = RenderConfig(width=W, height=H, trilinear_textures=True)
    assert cfg.enable_ssr and cfg.gtao.mis and cfg.taa.jitter
    jres = JRes(
        pdf_lut=jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT_SIZE),
        brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
        halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    res = ssr_resources_from_numpy(jres, "cpu")
    scene = upload_scene(load_scene(gltf_path, tex_size=TEX_SIZE,
                                    native_sizes=True), "cpu")

    def jgbuffer(g):
        return JGBuffer(**{k: jnp.asarray(getattr(g, k).numpy())
                           for k in JGBuffer._fields})

    def outputs(color, aux):
        out = {k: np.asarray(aux[k]) for k in CHANNELS[:-1]}
        out["color"] = np.asarray(color)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        jframe = jax.jit(lambda g, st, c: j_shade(g, st, c, jres, jcfg,
                                                  use_pallas=False))
        jstate = JState.initial(H, W)
        state = FrameState.initial(H, W, "cpu")
        out = []
        for i in range(N_FRAMES):
            view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
            color, state, aux = render_frame(
                scene, state, camera_frame(cfg, view, prev, i, "cpu"), res,
                cfg)
            jcolor, jstate, jaux = jframe(jgbuffer(aux["gbuffer"]), jstate,
                                          j_camera(jcfg, view, prev, i))
            out.append((outputs(jcolor, jaux), outputs(color, aux)))
    return out


@pytest.mark.parametrize("channel", CHANNELS)
def test_frame_channel_psnr(frames, channel):
    """>= 40 dB on the blurred SSR, the AO and the final colour of every
    frame of the trilinear glTF frame."""
    worst = min(psnr(got[channel], want[channel]) for want, got in frames)
    print(f"{channel}: {worst:.2f} dB (min over frames)")
    for i, (want, got) in enumerate(frames):
        assert got[channel].shape == want[channel].shape
        assert np.isfinite(got[channel]).all()
        assert psnr(got[channel], want[channel]) >= 40.0, (channel, i)


def test_ssr_is_exercised(frames):
    """The reflections are not empty in the glTF hall."""
    for _, got in frames[1:]:
        assert (got["ssr"][..., :3] > 0).any(-1).mean() > 0.01
