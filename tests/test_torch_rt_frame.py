"""The port's ray-traced GTAO frame (gtao.use_ray_query with a scene grid)
against vkr_tpu's: two orbit frames of the 24-column colonnade hall
(tessellation 4) at 128x64 with the default RenderConfig (SSR on) and
use_ray_query, over vkr_tpu's grid of the hall (resolution 16, cap 8)
carried across by convert.tri_grid_from_numpy, so both sides trace the
same grid.

vkr_tpu shades through its oracle path (shade_frame(use_pallas=False),
jitted, its march patched to the no-drop oracle as in
test_torch_ssr_frame.py) on the port's G-buffer, which
test_torch_raster.py holds against vkr_tpu's Pallas-path G-buffer."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 128, 64
N_FRAMES = 2
LUT_SIZE = 64
GRID = dict(resolution=16, cap=8)

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _ray_query(cfg):
    return dataclasses.replace(
        cfg, gtao=dataclasses.replace(cfg.gtao, use_ray_query=True))


@pytest.fixture(scope="module")
def orbit():
    """Per frame: vkr_tpu's RT frame, the port's RT frame and the port's
    MIS frame (ao and colour, numpy) on the same G-buffer and cameras; and
    both grids."""
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import build_scene_tri_grid as j_build
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.convert import (scene_from_numpy,
                                       ssr_resources_from_numpy,
                                       tri_grid_from_numpy)
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    jcfg = _ray_query(JConfig(width=W, height=H))
    cfg = _ray_query(RenderConfig(width=W, height=H))
    assert cfg.enable_ssr and cfg.gtao.mis  # the default frame otherwise
    jres = JRes(
        pdf_lut=jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT_SIZE),
        brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
        halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    res = ssr_resources_from_numpy(jres, "cpu")
    scene = scene_from_numpy(scene_np, "cpu")
    jgrid = j_build(scene_np, **GRID)
    grid = tri_grid_from_numpy(jgrid, "cpu")

    def jgbuffer(g):
        return JGBuffer(**{k: jnp.asarray(getattr(g, k).numpy())
                           for k in JGBuffer._fields})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        jframe = jax.jit(lambda g, st, c: j_shade(
            g, st, c, jres, jcfg, tri_grid=jgrid, use_pallas=False))
        jstate = JState.initial(H, W)
        state = FrameState.initial(H, W, "cpu")
        mis_state = FrameState.initial(H, W, "cpu")
        out = []
        for i in range(N_FRAMES):
            view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
            cam = camera_frame(cfg, view, prev, i, "cpu")
            color, state, aux = render_frame(scene, state, cam, res, cfg,
                                             tri_grid=grid)
            mis_color, mis_state, mis_aux = render_frame(
                scene, mis_state, cam, res, cfg)
            jcolor, jstate, jaux = jframe(jgbuffer(aux["gbuffer"]), jstate,
                                          j_camera(jcfg, view, prev, i))
            out.append({
                "want": {"ao": np.asarray(jaux["ao"]),
                         "color": np.asarray(jcolor)},
                "got": {"ao": aux["ao"].numpy(), "color": color.numpy()},
                "mis": {"ao": mis_aux["ao"].numpy(),
                        "color": mis_color.numpy()}})
    return out, jgrid, grid, scene_np


@pytest.mark.parametrize("channel", ["ao", "color"])
def test_rt_frame_psnr(orbit, channel):
    """>= 40 dB on the AO and the final colour of every frame. Measured
    (min over the frames): AO 107.90 dB, colour 71.10 dB."""
    frames = orbit[0]
    worst = min(psnr(f["got"][channel], f["want"][channel]) for f in frames)
    print(f"{channel}: {worst:.2f} dB (min over frames)")
    for i, f in enumerate(frames):
        got, want = f["got"][channel], f["want"][channel]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert psnr(got, want) >= 40.0, (channel, i)


def test_grid_branch_is_taken(orbit):
    """With a grid the AO is the ray-traced one: it differs from the MIS
    frame's on the same G-buffer (vkr_tpu's too)."""
    for f in orbit[0]:
        assert np.abs(f["got"]["ao"] - f["mis"]["ao"]).mean() > 0.01
        assert np.abs(f["want"]["ao"] - f["mis"]["ao"]).mean() > 0.01
        assert f["got"]["ao"].std() > 0.02


def test_tri_grid_carried_across(orbit):
    """tri_grid_from_numpy gives the port's own build_scene_tri_grid of the
    same scene, field for field (the frames above trace the carried
    grid)."""
    from vkr_tpu_torch.frame import build_scene_tri_grid

    _, jgrid, grid, scene_np = orbit
    own = build_scene_tri_grid(scene_np, device="cpu", **GRID)
    for name in ("tri_verts", "cell_tris", "grid_min", "cell_size"):
        assert torch.equal(getattr(grid, name), getattr(own, name)), name
        np.testing.assert_array_equal(getattr(grid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)))
    assert (grid.dims, grid.cap, grid.overflowed) == (
        own.dims, own.cap, own.overflowed) == (
        jgrid.dims, jgrid.cap, jgrid.overflowed)
    assert grid.overflowed > 0


def test_ray_query_without_grid_renders_the_mis_frame():
    """use_ray_query with no grid is the frame with use_ray_query off, bit
    for bit, as in vkr_tpu (frame.py: the RT pass needs both)."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=32, height=16)
    scene = upload_scene(colonnade_scene(columns=2, tessellation=6,
                                         tex_size=32), "cpu")
    res = build_ssr_resources(16, device="cpu")
    cam = camera_frame(cfg, bench_orbit_view(0), bench_orbit_view(0), 0,
                       "cpu")
    (base, _, base_aux), (color, _, aux) = [
        render_frame(scene, FrameState.initial(16, 32, "cpu"), cam, res, c)
        for c in (cfg, _ray_query(cfg))]
    torch.testing.assert_close(color, base, rtol=0, atol=0)
    torch.testing.assert_close(aux["ao"], base_aux["ao"], rtol=0, atol=0)
