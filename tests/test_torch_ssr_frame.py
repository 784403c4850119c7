"""The port's default frame (SSR on, MIS GTAO) against vkr_tpu's: three
orbit frames of the 24-column colonnade hall (the bench's geometry at
tessellation 4) at 256x128, LUT 64, so the history paths (SSR blur, GTAO
accumulate, TAA) run on the frames after the first.

vkr_tpu shades through its oracle path (shade_frame(use_pallas=False):
hi-Z, SSR trace/filter/blur, MIS GTAO, shading, TAA) with its march's
no-drop oracle, as the port drops no ray. Both sides shade the port's
G-buffer, which test_torch_raster.py holds against vkr_tpu's Pallas-path
G-buffer. vkr_tpu's own oracle raster (use_pallas=False) parts from its
Pallas raster on edge pixels of an in-hall view (ROADMAP queue 3), and
interpreting its Pallas raster here would cost a minute of compiles."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 256, 128
N_FRAMES = 3
LUT_SIZE = 64

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


CHANNELS = ["hiz_depth", "ssr", "ao", "color"]


def _outputs(color, aux):
    out = {k: np.asarray(aux[k].cpu() if isinstance(aux[k], torch.Tensor)
                         else aux[k]) for k in CHANNELS[:-1]}
    out["color"] = np.asarray(color.cpu() if isinstance(color, torch.Tensor)
                              else color)
    return out


@pytest.fixture(scope="module")
def orbit():
    """Per frame, vkr_tpu's oracle chain and the port's frame on the same
    G-buffer and cameras, and what both sides hold after the last frame."""
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.core.graph import PassGraph as JGraph
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.convert import (scene_from_numpy,
                                       ssr_resources_from_numpy)
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.graph import PassGraph
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    jcfg = JConfig(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    assert cfg.enable_ssr and cfg.gtao.mis  # the default frame
    jres = JRes(
        pdf_lut=jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT_SIZE),
        brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
        halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    res = ssr_resources_from_numpy(jres, "cpu")
    scene = scene_from_numpy(scene_np, "cpu")

    def jgbuffer(g):
        return JGBuffer(**{k: jnp.asarray(getattr(g, k).numpy())
                           for k in JGBuffer._fields})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        jframe = jax.jit(lambda g, st, c: j_shade(g, st, c, jres, jcfg,
                                                  use_pallas=False))
        jstate = JState.initial(H, W)
        state = FrameState.initial(H, W, "cpu")
        # frame 0's task chain on both sides (vkr_tpu's add_task records
        # while its jit traces shade_frame, on the first call)
        jgraph, graph = JGraph(), PassGraph()
        out = []
        for i in range(N_FRAMES):
            # bench.py's loop: frame i sees orbit view i after view i-1
            view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
            with (graph.recording() if i == 0
                  else contextlib.nullcontext()):
                color, state, aux = render_frame(
                    scene, state, camera_frame(cfg, view, prev, i, "cpu"),
                    res, cfg)
            with jgraph.recording():
                jcolor, jstate, jaux = jframe(jgbuffer(aux["gbuffer"]),
                                              jstate,
                                              j_camera(jcfg, view, prev, i))
            out.append((_outputs(jcolor, jaux), _outputs(color, aux)))
        # vkr_tpu's next frame from its own history, for
        # test_framestate_carried_across
        view = bench_orbit_view(N_FRAMES)
        prev = bench_orbit_view(N_FRAMES - 1)
        cam = camera_frame(cfg, view, prev, N_FRAMES, "cpu")
        gbuf = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter,
                              width=W, height=H,
                              quantize=cfg.quantize_formats,
                              mask_peel_layers=cfg.raster.mask_peel_layers)
        jcolor, _, jaux = jframe(jgbuffer(gbuf), jstate,
                                 j_camera(jcfg, view, prev, N_FRAMES))
    assert state.frame_index == N_FRAMES == int(jstate.frame_index)
    after = dict(jstate=jstate, cam=cam, jnext=_outputs(jcolor, jaux),
                 chains=([r.name for r in jgraph.records],
                         [r.name for r in graph.records]),
                 scene=scene, res=res, cfg=cfg)
    return out, after


@pytest.fixture(scope="module")
def frames(orbit):
    return orbit[0]


@pytest.mark.parametrize("channel", CHANNELS)
def test_frame_channel_psnr(frames, channel):
    """The repo's parity bar (BASELINE.json, tools/parity.py): >= 40 dB on
    the hi-Z base mip, the blurred SSR, the AO and the final colour, on
    every frame. The two sides differ by float32 rounding (XLA's jit
    contracts and reorders, the port rounds op by op), which the SSR ray
    setup and the MIS weights amplify on a few grazing pixels; the G-buffer
    itself is shared (module docstring)."""
    worst = min(psnr(got[channel], want[channel]) for want, got in frames)
    print(f"{channel}: {worst:.2f} dB (min over frames)")
    for i, (want, got) in enumerate(frames):
        assert got[channel].shape == want[channel].shape
        assert np.isfinite(got[channel]).all()
        assert psnr(got[channel], want[channel]) >= 40.0, (channel, i)


def test_ssr_is_exercised(frames):
    """SSR reflects something from the first frame on, and the history
    paths change the picture after it."""
    for want, got in frames:
        assert got["ssr"].max() > 0.02 and want["ssr"].max() > 0.02
        assert (got["hiz_depth"] < 1.0).mean() > 0.9
    assert frames[-1][1]["ssr"].max() > 0.2
    assert np.abs(frames[-1][1]["color"] - frames[0][1]["color"]).max() > 0.01


def test_framestate_carried_across(orbit):
    """framestate_from_numpy takes vkr_tpu's FrameState after the three
    frames (SSR history included) as it is, and the port continues the
    orbit from it at >= 40 dB against vkr_tpu's own next frame."""
    from vkr_tpu_torch.convert import framestate_from_numpy
    from vkr_tpu_torch.frame import render_frame

    _, after = orbit
    state = framestate_from_numpy(after["jstate"], "cpu")
    assert state.frame_index == N_FRAMES
    assert float(state.ssr_history.abs().max()) > 0.02
    color, new_state, aux = render_frame(after["scene"], state, after["cam"],
                                         after["res"], after["cfg"])
    assert new_state.frame_index == N_FRAMES + 1
    got = _outputs(color, aux)
    for channel in ("ssr", "ao", "color"):
        assert psnr(got[channel], after["jnext"][channel]) >= 40.0, channel


def test_task_chain_equals_vkr_tpu(orbit):
    """The default frame builds its passes through the registry under
    add_task: the port's recorded chain is GbufferPass, then vkr_tpu's
    shade_frame chain task for task (vkr_tpu shades the port's G-buffer
    here, so its records start after the G-buffer)."""
    jchain, chain = orbit[1]["chains"]
    assert jchain == [
        "DownsampleGbuffer", "SSSR_trace", "SSSR_filter", "SSSR_blur",
        "GTAO_main", "GTAO_filter", "GTAO_accumulate", "DeferedShading",
        "TAA"]
    assert chain == ["GbufferPass"] + jchain
