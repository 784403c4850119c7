"""The port's whole frame against vkr_tpu's: three orbit frames of a small
colonnade at 256x128 with SSR off, so the history paths (GTAO accumulate,
TAA) run on the frames after the first.

vkr_tpu renders through its oracle path (render_frame(use_pallas=False),
the path tools/parity.py compares against): its Pallas kernels in
interpret mode take minutes to compile on a CPU. Each kernel's plain
version is held against the interpreted Pallas kernel in
test_torch_raster.py and test_torch_gather.py."""

import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 256, 128
N_FRAMES = 3
LUT_SIZE = 64
REPO = Path(__file__).resolve().parent.parent


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _outputs(color, aux):
    g = aux["gbuffer"]
    out = {k: np.asarray(getattr(g, k).cpu() if isinstance(
        getattr(g, k), torch.Tensor) else getattr(g, k))
        for k in ("albedo", "normal", "material", "velocity", "depth")}
    for k, v in (("ao", aux["ao"]), ("color", color),
                 ("overflow", aux["overflow"])):
        out[k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module")
def orbit():
    """Per frame, the outputs of vkr_tpu's oracle frame and the port's, from
    the same CompiledScene and the same cameras; and what both sides hold
    after the last frame."""
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.core.graph import PassGraph as JGraph
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import render_frame as j_render
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu.passes import ssr as jssr
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.graph import PassGraph
    from vkr_tpu_torch.frame import build_ssr_resources, camera_frame
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    scene_np = colonnade_scene(columns=6, tessellation=8, tex_size=32)
    jcfg = JConfig(width=W, height=H, enable_ssr=False)
    cfg = RenderConfig(width=W, height=H, enable_ssr=False)

    # SSR is off: only the BRDF LUT is read (by shading)
    jres = JRes(pdf_lut=jnp.zeros((LUT_SIZE, LUT_SIZE), jnp.float32),
                brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
                halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    jscene = j_upload(scene_np)
    jframe = jax.jit(lambda s, st, c: j_render(s, st, c, jres, jcfg,
                                               use_pallas=False))
    jstate = JState.initial(H, W)

    res = build_ssr_resources(LUT_SIZE, device="cpu")
    scene = scene_from_numpy(scene_np, "cpu")
    state = FrameState.initial(H, W, "cpu")

    # frame 0's task chain on both sides (vkr_tpu's add_task records while
    # its jit traces the frame, on the first call)
    jgraph, graph = JGraph(), PassGraph()
    out = []
    for i in range(N_FRAMES):
        # bench.py's loop: frame i sees orbit view i, its previous view i-1
        view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
        with jgraph.recording():
            jcolor, jstate, jaux = jframe(jscene, jstate,
                                          j_camera(jcfg, view, prev, i))
        with (graph.recording() if i == 0 else contextlib.nullcontext()):
            color, state, aux = render_frame(
                scene, state, camera_frame(cfg, view, prev, i, "cpu"), res,
                cfg)
        out.append((_outputs(jcolor, jaux), _outputs(color, aux)))
    assert state.frame_index == N_FRAMES == int(jstate.frame_index)
    after = dict(jframe=jframe, jscene=jscene, jstate=jstate,
                 chains=([r.name for r in jgraph.records],
                         [r.name for r in graph.records]),
                 jcamera=j_camera(jcfg, bench_orbit_view(N_FRAMES),
                                  bench_orbit_view(N_FRAMES - 1), N_FRAMES),
                 scene=scene, state=state, res=res, cfg=cfg)
    return out, after


@pytest.fixture(scope="module")
def frames(orbit):
    return orbit[0]


CHANNELS = ["albedo", "normal", "material", "velocity", "depth", "ao",
            "color"]


@pytest.mark.parametrize("channel", CHANNELS)
def test_frame_channel_psnr(frames, channel):
    """The repo's parity bar (BASELINE.json, tools/parity.py): >= 40 dB per
    G-buffer channel, AO and final colour, on every frame. The two sides
    differ by float32 rounding (XLA's jit contracts and reorders, the port
    rounds op by op), which flips a few knife-edge pixels."""
    for i, (want, got) in enumerate(frames):
        assert got[channel].shape == want[channel].shape
        assert np.isfinite(got[channel]).all()
        assert psnr(got[channel], want[channel]) >= 40.0, (channel, i)


def test_frame_is_covered_and_without_overflow(frames):
    for want, got in frames:
        assert (got["depth"] < 1.0).mean() > 0.9
        assert int(got["overflow"]) == 0 == int(want["overflow"])
    # the history paths change the picture after the first frame
    assert np.abs(frames[-1][1]["color"] - frames[0][1]["color"]).max() > 0.01


def test_framestate_carried_across(orbit):
    """framestate_from_numpy takes vkr_tpu's FrameState after the three
    frames as it is, framestate_to_numpy gives the arrays back unchanged,
    and the port continues the orbit from vkr_tpu's history at >= 40 dB
    against vkr_tpu's own next frame (the bar of test_frame_channel_psnr)."""
    from vkr_tpu_torch.convert import (framestate_from_numpy,
                                       framestate_to_numpy)
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    _, after = orbit
    jstate = after["jstate"]
    state = framestate_from_numpy(jstate, "cpu")
    back = framestate_to_numpy(state)
    assert state.frame_index == N_FRAMES
    for name, arr in back.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jstate, name)))
    jcolor, _, jaux = after["jframe"](after["jscene"], jstate,
                                      after["jcamera"])
    cam = camera_frame(after["cfg"], bench_orbit_view(N_FRAMES),
                       bench_orbit_view(N_FRAMES - 1), N_FRAMES, "cpu")
    color, new_state, aux = render_frame(after["scene"], state, cam,
                                         after["res"], after["cfg"])
    assert new_state.frame_index == N_FRAMES + 1
    want, got = _outputs(jcolor, jaux), _outputs(color, aux)
    for channel in ("ao", "color"):
        assert psnr(got[channel], want[channel]) >= 40.0, channel


def test_task_chain_equals_vkr_tpu(orbit):
    """The SSR-off frame builds its passes through the registry under
    add_task: the port's recorded chain is vkr_tpu's, task for task."""
    jchain, chain = orbit[1]["chains"]
    assert chain == jchain == [
        "GbufferPass", "DownsampleGbuffer", "GTAO_main", "GTAO_filter",
        "GTAO_accumulate", "DeferedShading", "TAA"]


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and vkr_tpu out."""
    code = (
        "import pkgutil, importlib, sys, vkr_tpu_torch\n"
        "for m in pkgutil.walk_packages(vkr_tpu_torch.__path__, "
        "'vkr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith(('jax.', 'jaxlib')) or n == 'vkr_tpu' "
        "or n.startswith('vkr_tpu.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith('vkr_tpu_torch')))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    imported = done.stdout.split()
    assert len(imported) > 20
    for name in ("scene.accel", "passes.ssao", "passes.gtao", "frame",
                 "convert", "scene.gltf", "raster.resolve", "raster.kernel",
                 "scene.camera", "core.platform", "native", "tools.render",
                 "tools.parity", "tools.profile", "tools.scene_info",
                 "tools.viewer", "tools.showcase", "scene.jpeg", "core.aot",
                 "tools.bench", "tools.entry"):
        assert "vkr_tpu_torch." + name in imported, name


def test_trilinear_frame_renders_and_differs():
    """trilinear_textures renders (it raised before it was ported) and
    moves the albedo and the colour of a scene whose materials pair, and
    nothing of the geometry."""
    import dataclasses

    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=32, height=16, enable_ssr=False)
    scene = upload_scene(colonnade_scene(columns=2, tessellation=6,
                                         tex_size=32), "cpu")
    assert scene.tex.paired
    res = build_ssr_resources(16, device="cpu")
    cam = camera_frame(cfg, bench_orbit_view(0), bench_orbit_view(0), 0,
                       "cpu")
    outs = [render_frame(scene, FrameState.initial(16, 32, "cpu"), cam, res,
                         dataclasses.replace(cfg, trilinear_textures=on))
            for on in (False, True)]
    (base, _, base_aux), (color, _, aux) = outs
    assert torch.isfinite(color).all()
    assert not torch.equal(aux["gbuffer"].albedo, base_aux["gbuffer"].albedo)
    assert not torch.equal(color, base)
    torch.testing.assert_close(aux["gbuffer"].depth,
                               base_aux["gbuffer"].depth, rtol=0, atol=0)


def test_probes_without_grid_render_the_probeless_frame():
    """enable_probes with no probe grid is the probeless frame, as in
    vkr_tpu (frame.py: the probe pass needs both)."""
    import dataclasses

    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=32, height=16, enable_ssr=False)
    scene = upload_scene(colonnade_scene(columns=2, tessellation=6,
                                         tex_size=32), "cpu")
    res = build_ssr_resources(16, device="cpu")
    cam = camera_frame(cfg, bench_orbit_view(0), bench_orbit_view(0), 0,
                       "cpu")
    outs = [render_frame(scene, FrameState.initial(16, 32, "cpu"), cam, res,
                         dataclasses.replace(cfg, enable_probes=on))
            for on in (False, True)]
    (base, _, base_aux), (color, _, aux) = outs
    assert aux["probe"] is None and base_aux["probe"] is None
    torch.testing.assert_close(color, base, rtol=0, atol=0)
