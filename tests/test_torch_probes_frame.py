"""The port's frame with probe GI (RenderConfig(enable_probes=True),
BASELINE config 5) against vkr_tpu's, on the CPU:

- SSR off, as vkr_tpu's own config-5 test (tests/test_probes.py): the
  small colonnade at 64x64, GTAO and TAA off, one frame;
- SSR on, at 256x128 in the 24-column hall (the bench's geometry at
  tessellation 4), two orbit frames, so the probe hits fill the pixels SSR
  left empty and the composed reflections become the SSR history.

vkr_tpu shades through its oracle path (shade_frame(use_pallas=False),
its march's no-drop oracle as in tests/test_torch_ssr_frame.py) on the
port's G-buffer, and both sides trace the same probe grid: the port's,
carried to vkr_tpu's ProbeGrid (the grid's modules are held against
vkr_tpu in tests/test_torch_probes.py). Measured values print under
`pytest -s`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

LUT_SIZE = 64
PROBES = dict(grid=2, cube_size=16, oct_size=32)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _jax_grid(grid):
    """The port's ProbeGrid as vkr_tpu's."""
    from vkr_tpu.passes.probes import ProbeGrid as JGrid

    return JGrid(colors=jnp.asarray(_np(grid.colors)),
                 depth_flat=jnp.asarray(_np(grid.depth_flat)),
                 mip_offsets=grid.mip_offsets, mip_sizes=grid.mip_sizes,
                 probe_min=jnp.asarray(_np(grid.probe_min)),
                 probe_max=jnp.asarray(_np(grid.probe_max)),
                 grid_size=grid.grid_size)


def _jax_gbuffer(g):
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer

    return JGBuffer(**{k: jnp.asarray(_np(getattr(g, k)))
                       for k in JGBuffer._fields})


def _configs(**kw):
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu_torch.config import RenderConfig

    return tuple(dataclasses.replace(
        c(**kw), probes=dataclasses.replace(c().probes, **PROBES))
        for c in (JConfig, RenderConfig))


def _resources():
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu_torch.convert import ssr_resources_from_numpy

    jres = JRes(
        pdf_lut=jax.jit(jssr.preintegrate_pdf, static_argnums=0)(LUT_SIZE),
        brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
        halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    return jres, ssr_resources_from_numpy(jres, "cpu")


@pytest.fixture(scope="module")
def config5():
    """vkr_tpu's config-5 frame (SSR, GTAO and TAA off) through both
    sides, and the port's frame without probes."""
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.mathlib import look_at
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_probe_grid, camera_frame,
                                     render_frame)

    size = 64
    jcfg, cfg = _configs(width=size, height=size, enable_ssr=False,
                         enable_gtao=False, enable_taa=False,
                         quantize_formats=False, enable_probes=True)
    scene_np = colonnade_scene(columns=2, tessellation=6, tex_size=32,
                               foliage=False)
    grid = build_probe_grid(scene_np, cfg, device="cpu")
    jres, res = _resources()
    view = look_at((0, 1.2, -3), (0, 1.0, 1), (0, -1, 0))
    scene = scene_from_numpy(scene_np, "cpu")
    cam = camera_frame(cfg, view, view, 0, "cpu")
    color, _, aux = render_frame(scene, FrameState.initial(size, size, "cpu"),
                                 cam, res, cfg, probe_grid=grid)
    base, _, _ = render_frame(scene, FrameState.initial(size, size, "cpu"),
                              cam, res, dataclasses.replace(
                                  cfg, enable_probes=False))
    jcolor, _, jaux = j_shade(_jax_gbuffer(aux["gbuffer"]),
                              JState.initial(size, size),
                              j_camera(jcfg, view, view, 0), jres, jcfg,
                              probe_grid=_jax_grid(grid), use_pallas=False)
    return ({"ssr": _np(jaux["ssr"]), "color": _np(jcolor)},
            {"ssr": _np(aux["ssr"]), "color": _np(color)}, _np(base))


@pytest.mark.parametrize("channel", ["ssr", "color"])
def test_config5_frame_psnr(config5, channel):
    """The repo's parity bar (>= 40 dB) on the probe reflections (which
    take the SSR's place) and the final colour."""
    want, got, _ = config5
    value = psnr(got[channel], want[channel])
    print(f"config 5 {channel}: {value:.2f} dB")
    assert got[channel].shape == want[channel].shape
    assert np.isfinite(got[channel]).all()
    assert value >= 40.0


def test_config5_probes_light_the_frame(config5):
    """As vkr_tpu's config-5 test: the reflections brighten a visible part
    of the frame against the probeless frame."""
    _, got, base = config5
    assert got["ssr"].max() > 0.02
    assert (np.abs(got["color"] - base).max(-1) > 1e-4).mean() > 0.02


@pytest.fixture(scope="module")
def hall():
    """Two orbit frames of the default frame with probes (SSR on) in the
    24-column hall."""
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_probe_grid, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    w, h = 256, 128
    jcfg, cfg = _configs(width=w, height=h, enable_probes=True)
    assert cfg.enable_ssr and cfg.gtao.mis
    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    grid = build_probe_grid(scene_np, cfg, device="cpu")
    jgrid = _jax_grid(grid)
    jres, res = _resources()
    scene = scene_from_numpy(scene_np, "cpu")
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        jframe = jax.jit(lambda g, st, c: j_shade(
            g, st, c, jres, jcfg, probe_grid=jgrid, use_pallas=False))
        jstate, state = JState.initial(h, w), FrameState.initial(h, w, "cpu")
        for i in range(2):
            view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
            color, state, aux = render_frame(
                scene, state, camera_frame(cfg, view, prev, i, "cpu"), res,
                cfg, probe_grid=grid)
            jcolor, jstate, jaux = jframe(_jax_gbuffer(aux["gbuffer"]),
                                          jstate, j_camera(jcfg, view, prev,
                                                           i))
            empty = _np(aux["ssr_rays"][..., 3]) >= 1.0
            filled = empty & (_np(aux["probe"][..., 3]) > 0.0)
            out.append(({"ssr": _np(jaux["ssr"]), "color": _np(jcolor)},
                        {"ssr": _np(aux["ssr"]), "color": _np(color)},
                        float(filled.sum() / empty.sum())))
        assert np.array_equal(_np(state.ssr_history), out[-1][1]["ssr"])
    return out, grid


@pytest.mark.parametrize("channel", ["ssr", "color"])
def test_hall_frame_psnr(hall, channel):
    """>= 40 dB on the composed reflections (SSR, probe hits where SSR
    left a pixel empty) and the final colour, on both frames."""
    frames, _ = hall
    worst = min(psnr(got[channel], want[channel])
                for want, got, _ in frames)
    print(f"hall {channel}: {worst:.2f} dB (min over frames)")
    for want, got, _ in frames:
        assert np.isfinite(got[channel]).all()
        assert psnr(got[channel], want[channel]) >= 40.0


def test_hall_probes_fill_ssr_empty_pixels(hall):
    frames, grid = hall
    filled = [f for _, _, f in frames]
    print(f"hall: probes fill {filled} of the SSR-empty pixels")
    assert min(filled) > 0.0
    assert int(grid.face_overflow.max()) == 0
