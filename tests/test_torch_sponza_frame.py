"""The slice as a whole on the CPU: bench.py's Sponza-textured colonnade
(sponza_colonnade_scene on chip_smoke.write_sponza_standin's stand-in in
Sponza's layout: 25 materials, 69 textures, the foliage on a MASK
material with alphaCutoff 0.3) uploaded and rendered with RenderConfig()
(SSR on, MIS GTAO, TAA, bilinear at the rounded mip) at 256x128 for 3
orbit frames, against vkr_tpu on the same stand-in.

The hall is the 24-column one, where the bench orbit's eye is inside and
SSR rays hit, at tessellation 4 and 32² textures. The G-buffer is held to
vkr_tpu's production path (its Pallas kernel interpreted, run eagerly:
one interpret-mode compile of each K1 shape is most of this file's
time); the rest of each frame to vkr_tpu's oracle shade_frame on the
port's G-buffer, its march patched to drop no ray, as the port's does
(tests/test_torch_ssr_frame.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

W, H = 256, 128
N_FRAMES = 3
LUT_SIZE = 64
SCENE = dict(columns=24, tessellation=4, tex_size=32)
CHANNELS = ["ssr", "ao", "color"]


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The stand-in Sponza colonnade through both packages (vkr_tpu's
    SPONZA_GLTF patched to the stand-in) and the port's upload."""
    import vkr_tpu.scene.procedural as j_proc
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import sponza_colonnade_scene

    root = str(tmp_path_factory.mktemp("assets"))
    path, _ = chip_smoke.write_sponza_standin(root, seed=0,
                                              size_scale=1 / 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKR_ASSETS", root)
        mp.setattr(j_proc, "SPONZA_GLTF", path)
        scene_np = sponza_colonnade_scene(**SCENE)
        jscene_np = j_proc.sponza_colonnade_scene(**SCENE)
    return scene_np, jscene_np, upload_scene(scene_np, "cpu")


def _camera(i):
    from vkr_tpu.config import RenderConfig
    from vkr_tpu.frame import camera_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    cfg = RenderConfig(width=W, height=H)
    return cfg, camera_frame(cfg, bench_orbit_view(i),
                             bench_orbit_view(max(i - 1, 0)), i)


@pytest.fixture(scope="module")
def gbuffer_pair(scenes):
    """Frame 2's G-buffer through vkr_tpu's production path (corner
    tables, its Pallas kernel interpreted) and the port's."""
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer

    _, jscene_np, scene = scenes
    cfg, cam = _camera(2)
    kw = dict(width=W, height=H, quantize=True,
              mask_peel_layers=cfg.raster.mask_peel_layers)
    jg = j_render(j_upload(jscene_np), cam.mvp, cam.prev_mvp, cam.jitter,
                  use_pallas=True, interpret=True, **kw)
    args = [torch.from_numpy(np.array(a)) for a in
            (cam.mvp, cam.prev_mvp, cam.jitter)]
    return jg, render_gbuffer(scene, *args, **kw)


@pytest.mark.parametrize("channel", ["albedo", "normal", "material",
                                     "velocity", "depth"])
def test_gbuffer_channel_psnr(gbuffer_pair, channel):
    """The repo's parity bar (BASELINE.json, tools/parity.py)."""
    jg, tg = gbuffer_pair
    got = getattr(tg, channel).numpy()
    want = np.asarray(getattr(jg, channel))
    assert got.shape == want.shape
    value = psnr(got, want)
    print(f"{channel}: {value:.2f} dB")
    assert value >= 40.0, channel


def test_gbuffer_depth_and_sponza_materials(gbuffer_pair, scenes):
    """Depth equal on the covered pixels, no bin pair dropped, the hall
    covered; the pixels show Sponza materials' textures, the foliage's
    MASK discarding by its cutoff of 0.3."""
    jg, tg = gbuffer_pair
    scene_np, _, scene = scenes
    got, want = tg.depth.numpy(), np.asarray(jg.depth)
    covered = (got < 1.0) | (want < 1.0)
    assert covered.mean() > 0.9
    assert (got[covered] == want[covered]).mean() >= 0.999
    assert int(tg.overflow) == 0 == int(jg.overflow)
    assert scene.tex.paired and scene.tex.base_size == SCENE["tex_size"]
    assert len(scene.tex.wrap) == 69
    masked = scene_np.mat_clip_alpha[scene_np.tri_material] > 0
    assert masked.sum() == 2 * 2 * SCENE["columns"]
    assert float(scene_np.mat_alpha_cutoff[
        scene_np.tri_material[masked][0]]) == pytest.approx(0.3)


@pytest.fixture(scope="module")
def frames(scenes):
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
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    jcfg = JConfig(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    assert cfg.enable_ssr and cfg.gtao.mis and cfg.taa.jitter
    jres = JRes(
        pdf_lut=jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT_SIZE),
        brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
        halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    res = ssr_resources_from_numpy(jres, "cpu")
    scene = scenes[2]

    def jgbuffer(g):
        return JGBuffer(**{k: jnp.asarray(getattr(g, k).numpy())
                           for k in JGBuffer._fields})

    def outputs(color, aux):
        out = {k: np.asarray(aux[k]) for k in CHANNELS[:-1]}
        out["color"] = np.asarray(color)
        out["depth"] = np.asarray(aux["gbuffer"].depth)
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
            got = outputs(color, aux)
            want = outputs(jcolor, jaux)
            want["depth"] = got["depth"]
            out.append((want, got))
    return out


@pytest.mark.parametrize("channel", CHANNELS)
def test_frame_channel_psnr(frames, channel):
    """>= 40 dB on the blurred SSR, the AO and the final colour of every
    frame of the stand-in Sponza colonnade."""
    worst = min(psnr(got[channel], want[channel]) for want, got in frames)
    print(f"{channel}: {worst:.2f} dB (min over frames)")
    for i, (want, got) in enumerate(frames):
        assert got[channel].shape == want[channel].shape
        assert np.isfinite(got[channel]).all()
        assert psnr(got[channel], want[channel]) >= 40.0, (channel, i)


def test_frames_cover_the_hall_and_reflect(frames):
    """Every frame covers >= 0.98 of the pixels (chip_smoke.py's bar) and
    its reflections are not empty."""
    for i, (_, got) in enumerate(frames):
        assert (got["depth"] < 1.0).mean() >= chip_smoke.MIN_COVERAGE, i
        if i:
            assert (got["ssr"][..., :3] > 0).any(-1).mean() > 0.01, i
