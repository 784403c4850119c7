"""__graft_entry__.py's entry points on the port (tools/entry.py), on the CPU:
entry()'s frame against vkr_tpu's oracle path on the same scene, camera
and config (__graft_entry__.py's), and dryrun_multichip on gloo ranks.

vkr_tpu renders through its oracle path (use_pallas=False) with its
march's no-drop oracle (`_hierarchical_march(..., compact_frac=0.0)`: the
port drops no ray) and the port's LUTs; its Pallas kernels in interpret
mode take minutes to compile here (its G-buffer alone 101 s at 128x128).
Its oracle raster is not its Pallas raster (ROADMAP queue 3): on this
view the G-buffer normal of the entry frame is 37 dB from vkr_tpu's
oracle frame's. So, as the frame tests do, both sides shade one G-buffer,
the entry frame's: hi-Z, SSR, AO and colour are held to vkr_tpu's
shade_frame(use_pallas=False) on it. The entry frame's albedo, material,
velocity and depth are held to vkr_tpu's oracle raster; the normal is
held to vkr_tpu's Pallas raster in test_torch_raster_gbuffer.py, where
the kernel's plain version meets it."""

import functools
import time

import numpy as np
import pytest
import torch

from vkr_tpu_torch.tools import entry as E

torch.set_num_threads(1)

MIN_PSNR_DB = 40.0
# held to vkr_tpu's oracle raster (its full use_pallas=False frame)
RASTER_CHANNELS = ("albedo", "material", "velocity", "depth")
# held to vkr_tpu's shade_frame(use_pallas=False) on the entry's G-buffer
SHADED_CHANNELS = ("hiz_depth", "ssr", "ao", "color")


@pytest.fixture(autouse=True)
def _cache(monkeypatch, tmp_path_factory):
    monkeypatch.setenv("VKR_DISK_CACHE",
                       str(tmp_path_factory.getbasetemp() / "luts"))


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _channels(color, aux):
    g = aux["gbuffer"]
    out = {k: np.asarray(getattr(g, k)) for k in RASTER_CHANNELS}
    out.update({k: np.asarray(aux[k]) for k in SHADED_CHANNELS[:-1]},
               color=np.asarray(color))
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """entry(platform="cpu")'s frame, render_frame on its arguments (for
    aux), vkr_tpu's oracle frame of __graft_entry__'s config, scene and
    camera, and vkr_tpu's oracle shade_frame on the port's G-buffer; both
    with the port's LUTs."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import render_frame as j_render
    from vkr_tpu.frame import shade_frame as j_shade
    from vkr_tpu.mathlib import look_at
    from vkr_tpu.passes.gbuffer import GBuffer as JGBuffer
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene import colonnade_scene
    from vkr_tpu_torch.frame import render_frame

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKR_DISK_CACHE",
                  str(tmp_path_factory.getbasetemp() / "luts"))
        fn, (scene, state, cam) = E.entry(platform="cpu")
        color, new_state = fn(scene, state, cam)
        cfg = E.small_config()
        _, res = E.scene_and_resources("cpu")
        color_r, state_r, aux = render_frame(scene, state, cam, res, cfg)

        jcfg = graft._small_cfg()
        jres = JRes(**{k: jnp.asarray(getattr(res, k).numpy())
                       for k in JRes._fields})
        jscene = j_upload(colonnade_scene(columns=3, tessellation=8,
                                          tex_size=64))
        view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
        jcam = j_camera(jcfg, view, view, 0)
        jstate = JState.initial(jcfg.height, jcfg.width)
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        jcolor, _, jaux = jax.jit(lambda s, st, c: j_render(
            s, st, c, jres, jcfg, use_pallas=False))(jscene, jstate, jcam)
        gbuf = JGBuffer(**{k: jnp.asarray(getattr(aux["gbuffer"],
                                                  k).numpy())
                           for k in JGBuffer._fields})
        scolor, _, saux = jax.jit(lambda g, st, c: j_shade(
            g, st, c, jres, jcfg, use_pallas=False))(gbuf, jstate, jcam)
    return dict(fn=(color, new_state), direct=(color_r, state_r, aux),
                got=_channels(color_r, aux), raster=_channels(jcolor, jaux),
                shaded=_channels(scolor, saux), cfg=(cfg, jcfg),
                overflow=(int(aux["overflow"]), int(jaux["overflow"])))


def test_entry_is_render_frame(frames):
    """fn is render_frame through the kernels' plain versions on these
    arguments: colour and every FrameState field equal bit for bit; the
    frame covers the view and drops no bin pair."""
    (color, state), (color_r, state_r, aux) = frames["fn"], frames["direct"]
    cfg, jcfg = frames["cfg"]
    assert (cfg.width, cfg.height, cfg.ssr.max_iterations) == (
        jcfg.width, jcfg.height, jcfg.ssr.max_iterations) == (128, 128, 16)
    assert color.shape == (128, 128, 3) and color.device.type == "cpu"
    assert torch.equal(color, color_r)
    for name in state.FIELDS:
        assert torch.equal(getattr(state, name), getattr(state_r, name)), name
    assert int(state.frame_index) == 1
    assert frames["overflow"] == (0, 0)
    assert (frames["got"]["depth"] < 1.0).mean() > 0.5
    assert (aux["ssr_rays"][..., 3] < 1.0).float().mean() > 0.01  # hits


@pytest.mark.parametrize("channel", RASTER_CHANNELS + SHADED_CHANNELS)
def test_entry_frame_psnr(frames, channel):
    """The repo's parity bar (BASELINE.json, tools/parity.py): >= 40 dB per
    G-buffer channel (the normal aside, see the module docstring) against
    vkr_tpu's oracle raster, and on the hi-Z base mip, the blurred SSR,
    the AO and the colour against vkr_tpu's oracle shading of the entry
    frame's G-buffer."""
    want = frames["raster" if channel in RASTER_CHANNELS else "shaded"]
    got, want = frames["got"][channel], want[channel]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert psnr(got, want) >= MIN_PSNR_DB, (channel, psnr(got, want))


def test_dryrun_multichip_on_cpu_ranks(capsys):
    """4 gloo ranks on the CPU: vkr_tpu's two OK lines; the band frame
    equals each rank's one-device frame (the G-buffer and prev_depth bit
    for bit inside the rank, the colour within 1e-6)."""
    got = E.dryrun_multichip(4, platform="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == ("dryrun_multichip(4): views OK — colors (4, 64, 64, "
                       f"3), coverage {got['coverage']:.3f}")
    assert out[-1].startswith("dryrun_multichip(4): bands OK — (64, 64, 3) "
                              "matches single-device")
    assert got["coverage"] > E.MIN_COVERAGE
    assert got["max_dev"] <= E.BAND_ATOL


def _raising_job(rank, n, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as dist

    dist.barrier()  # waits for rank 1, which never comes
    return {}


def test_a_failing_rank_fails_the_run(monkeypatch):
    """A rank that raises makes run_ranks, dryrun_multichip's runner,
    raise at once with its traceback, the other ranks stopped; a dry run
    whose ranks outlive RANK_TIMEOUT_S raises TimeoutError."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        E.run_ranks(_raising_job, 2, "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60
    monkeypatch.setattr(E, "RANK_TIMEOUT_S", 0.5)
    with pytest.raises(TimeoutError, match="no result after 0.5 s"):
        E.dryrun_multichip(2, platform="cpu")


@pytest.mark.parametrize("n", [0, 3, 5, 64])
def test_dryrun_rejects_uneven_bands(n):
    with pytest.raises(ValueError, match="bands of an even height"):
        E.dryrun_multichip(n, platform="cpu")


def test_no_card_no_fallback(monkeypatch):
    """Without a card, and without the CPU asked for, both raise before
    building anything."""
    monkeypatch.delenv("VKR_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        E.dryrun_multichip(4)
