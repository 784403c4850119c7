"""The port's GTAO variants and SSAO against vkr_tpu's on identical inputs:
gtao_rt over a scene grid, gtao_main_exact, gtao_main_dense,
gtao_normal_space, both modes of gtao_reproject, the deinterleaved main
pass and its (de)interleave, ssao, and the direction tables.

The inputs are one orbit frame of the 24-column colonnade hall, rendered
by the port at 64x64 on the CPU (hi-Z gives the 32x32 half-res depth and
normals), handed to both packages as the same numpy arrays. vkr_tpu runs
eagerly; its loops (lax.fori_loop) are compiled, so XLA contracts their
products into fmas, and its float32 sin, cos and arccos are not PyTorch's
to the last bit. The passes are therefore held by PSNR (the repo's 40 dB
bar, BASELINE.json) with the max abs error stated, and gtao_rt also by
the share of pixels that differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.passes import gtao as jgtao
from vkr_tpu.passes import ssao as jssao
from vkr_tpu_torch.passes import gtao as tgtao
from vkr_tpu_torch.passes import ssao as tssao

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

SIZE = 64
BASE_ANGLE = 0.37


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def frame():
    """Full-res depth, half-res depth and normals, cameras and projection
    (numpy) of orbit frame 1 at 64x64, and the scene."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.mathlib.transforms import perspective
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=SIZE, height=SIZE)
    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1,
                       "cpu")
    g = render_gbuffer(upload_scene(scene_np, "cpu"), cam.mvp, cam.prev_mvp,
                       cam.jitter, width=SIZE, height=SIZE, quantize=True,
                       mask_peel_layers=2)
    hiz = build_hiz(g.depth, g.normal, g.velocity)
    out = dict(
        depth=_np(g.depth), depth_half=_np(hiz.mips[0]),
        normal_half=_np(hiz.normal_half),
        inv_view=_np(_inv4(cam.view)), normal_mat=_np(_normal_mat4(cam.view)),
        proj=perspective(cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                         cfg.camera.zfar).astype(np.float32),
        cam=(cfg.camera.fovy, cfg.aspect, cfg.camera.znear, cfg.camera.zfar),
        scene_np=scene_np)
    assert (out["depth_half"] < 1.0).mean() > 0.9
    return out


def _params(fr, mod, conv):
    return mod.GTAOParams(conv(fr["normal_mat"]), *fr["cam"])


def _both(fr, name, *extra):
    """vkr_tpu's and the port's pass `name` on the half-res inputs."""
    want = getattr(jgtao, name)(
        jnp.asarray(fr["depth_half"]), jnp.asarray(fr["normal_half"]),
        _params(fr, jgtao, jnp.asarray), jnp.float32(BASE_ANGLE), *extra)
    got = getattr(tgtao, name)(
        torch.from_numpy(fr["depth_half"]),
        torch.from_numpy(fr["normal_half"]),
        _params(fr, tgtao, torch.from_numpy), BASE_ANGLE, *extra)
    return _np(got), np.asarray(want)


def test_direction_tables_bit_equal():
    np.testing.assert_array_equal(tgtao.ao_ray_directions(64),
                                  jgtao.ao_ray_directions(64))
    np.testing.assert_array_equal(tgtao.ao_ray_directions(16, seed=3),
                                  jgtao.ao_ray_directions(16, seed=3))
    np.testing.assert_array_equal(tssao.sphere_samples(),
                                  jssao.sphere_samples())


@pytest.mark.parametrize("name,extra,min_db", [
    # measured: exact 93.62 dB (max abs 3.5e-4), two directions 96.22 dB
    # (2.2e-4), dense 88.67 dB (5.3e-4), normal space 103.48 dB (1.8e-4),
    # deinterleaved 91.32 dB (5.0e-4)
    ("gtao_main_exact", (), 40.0),
    ("gtao_main_exact", (2,), 40.0),
    ("gtao_main_dense", (), 40.0),
    ("gtao_normal_space", (), 40.0),
    ("gtao_main_deinterleaved", (), 40.0),
])
def test_variant_matches_vkr_tpu(frame, name, extra, min_db):
    got, want = _both(frame, name, *extra)
    err = np.abs(got - want).max()
    print(f"{name}{extra}: {psnr(got, want):.2f} dB, max abs {err:.3g}")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.std() > 0.05  # real occlusion, not a flat image
    assert psnr(got, want) >= min_db


@pytest.mark.parametrize("matrix_mode", [False, True])
def test_reproject_matches_vkr_tpu(frame, matrix_mode):
    """Both modes, the previous frame being this one's depth and a seeded
    AO image: STATIC keeps the pixels whose depth matches within the bias
    (all of them here), MATRIX reprojects through the projection and keeps
    the bit-stable round trips. Measured: STATIC bit-equal; MATRIX keeps
    0.4199 of the pixels on both sides, 133.00 dB, max abs 1.6e-6."""
    rng = np.random.default_rng(5)
    d = frame["depth_half"]
    cur_ao = rng.uniform(0, 1, d.shape).astype(np.float32)
    prev_ao = rng.uniform(0, 1, d.shape).astype(np.float32)
    m = frame["proj"]
    if matrix_mode:
        # the previous frame's NDC shifted by half a texel, so each point
        # lands on its own pixel's centre (reproject.comp's uv is the
        # pixel's corner)
        shift = np.eye(4, dtype=np.float32)
        shift[:2, 3] = [1.0 / d.shape[1], 1.0 / d.shape[0]]
        m = shift @ m
    want = np.asarray(jgtao.gtao_reproject(
        jnp.asarray(d), jnp.asarray(d), jnp.asarray(cur_ao),
        jnp.asarray(prev_ao), jnp.asarray(m), *frame["cam"],
        matrix_mode=matrix_mode))
    got = _np(tgtao.gtao_reproject(
        *(torch.from_numpy(a) for a in (d, d, cur_ao, prev_ao, m)),
        *frame["cam"], matrix_mode=matrix_mode))
    kept = float((want != cur_ao).mean())
    err = np.abs(got - want).max()
    print(f"reproject matrix_mode={matrix_mode}: kept {kept:.4f}, "
          f"{psnr(got, want):.2f} dB, max abs {err:.3g}")
    assert kept > 0.05  # the blend is exercised
    assert psnr(got, want) >= 40.0


def test_deinterleave_bit_equal(frame):
    d = frame["depth_half"]
    for step in (1, 2):
        want = np.asarray(jgtao.deinterleave_depth(jnp.asarray(d), step))
        got = tgtao.deinterleave_depth(torch.from_numpy(d), step)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tgtao.interleave_layers(got, step).numpy(),
            np.asarray(jgtao.interleave_layers(jnp.asarray(want), step)))
        np.testing.assert_array_equal(
            tgtao.interleave_layers(got, step).numpy(), d)


def test_ssao_matches_vkr_tpu(frame):
    """Full-res 64x64. Measured: bit-equal (inf dB), mean 0.5269. One
    flipped depth test would move a pixel by 1/16."""
    fovy, aspect, znear, zfar = frame["cam"]
    d = frame["depth"]
    want = np.asarray(jssao.ssao(jnp.asarray(d), jssao.SSAOParams(
        jnp.asarray(frame["proj"]), fovy, aspect, znear, zfar)))
    got = _np(tssao.ssao(torch.from_numpy(d), tssao.SSAOParams(
        torch.from_numpy(frame["proj"]), fovy, aspect, znear, zfar)))
    err = np.abs(got - want).max()
    print(f"ssao: {psnr(got, want):.2f} dB, max abs {err:.3g}, mean "
          f"{want.mean():.4f}")
    assert want.std() > 0.05
    assert psnr(got, want) >= 40.0


def test_window_matches_exact(frame):
    """The port's K4 pass (its plain version here) against its own
    gtao_main_exact, to the bound vkr_tpu holds its pair to
    (tests/test_passes.py: max < 1e-3, mean < 5e-5). Measured: max
    3.0e-4, mean 3.9e-7."""
    args = (torch.from_numpy(frame["depth_half"]),
            torch.from_numpy(frame["normal_half"]),
            _params(frame, tgtao, torch.from_numpy), BASE_ANGLE)
    diff = (tgtao.gtao_main_window(*args) - tgtao.gtao_main_exact(*args)).abs()
    print(f"window vs exact: max {diff.max():.3g}, mean {diff.mean():.3g}")
    assert diff.max() < 1e-3 and diff.mean() < 5e-5


def test_gtao_rt_matches_vkr_tpu(frame):
    """16 directions at 32x32 over the hall's grid (resolution 16, cap 8,
    1,284 pairs dropped on both sides). Measured: no pixel differs by more
    than 1e-5 (share 0.0), max abs 1.2e-7, 162.04 dB: the hits are the
    same, the sums round apart."""
    from vkr_tpu.frame import build_scene_tri_grid as j_build
    from vkr_tpu_torch.frame import build_scene_tri_grid as t_build

    jg = j_build(frame["scene_np"], resolution=16, cap=8)
    tg = t_build(frame["scene_np"], resolution=16, cap=8, device="cpu")
    dirs = tgtao.ao_ray_directions(16)
    args = (*frame["cam"], BASE_ANGLE)
    want = np.asarray(jgtao.gtao_rt(
        jnp.asarray(frame["depth_half"]), jnp.asarray(frame["normal_half"]),
        jg, jnp.asarray(frame["inv_view"]), *args, jnp.asarray(dirs)))
    got = _np(tgtao.gtao_rt(
        torch.from_numpy(frame["depth_half"]),
        torch.from_numpy(frame["normal_half"]), tg,
        torch.from_numpy(frame["inv_view"]), *args, torch.from_numpy(dirs)))
    differ = float((np.abs(got - want) > 1e-5).mean())
    err = np.abs(got - want).max()
    print(f"gtao_rt: differing share {differ}, max abs {err:.3g}, "
          f"{psnr(got, want):.2f} dB, mean AO {want.mean():.4f}")
    assert want.std() > 0.05 and want.min() < 1.0
    assert differ <= 0.01
    assert psnr(got, want) >= 40.0


def test_window_exact_pair_on_a_far_frame():
    """On a real frame with far depths (the hall at 512x256, half-res
    256x128) the taps' rounding, amplified by the reciprocal depth near
    d = 1 and the thickness break, parts K4's pass from gtao_main_exact by
    more than vkr_tpu's max bound, for vkr_tpu's own pair too (its K4
    stood in by its jnp oracle window_gather_reference). Measured: port
    max 0.0193, mean 2.1e-6, 9 pixels over 1e-3; vkr_tpu max 2.78, mean
    1.24e-4, 70 pixels. The port's pair holds the mean bound and stays no
    further apart than vkr_tpu's."""
    from vkr_tpu.raster import gather_kernel as jgather
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _normal_mat4, camera_frame
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    w, h = 512, 256
    cfg = RenderConfig(width=w, height=h)
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1,
                       "cpu")
    g = render_gbuffer(upload_scene(colonnade_scene(
        columns=24, tessellation=4, tex_size=32), "cpu"), cam.mvp,
        cam.prev_mvp, cam.jitter, width=w, height=h, quantize=True,
        mask_peel_layers=2)
    hiz = build_hiz(g.depth, g.normal, g.velocity)
    d, n = hiz.mips[0], hiz.normal_half
    lens = (cfg.camera.fovy, cfg.aspect, cfg.camera.znear, cfg.camera.zfar)
    nm = _normal_mat4(cam.view)
    angle = tgtao.frame_base_angle(1)
    targs = (d, n, tgtao.GTAOParams(nm, *lens), angle)
    port = (tgtao.gtao_main_window(*targs)
            - tgtao.gtao_main_exact(*targs)).abs().numpy()

    def k4_oracle(img, off_y, off_x, *, radius, interpret, row0):
        return jnp.stack([jgather.window_gather_reference(
            img, off_y[k], off_x[k], radius) for k in range(off_y.shape[0])])

    jargs = (jnp.asarray(d.numpy()), jnp.asarray(n.numpy()),
             jgtao.GTAOParams(jnp.asarray(nm.numpy()), *lens),
             jnp.float32(angle))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgather, "window_gather_bilinear_multi", k4_oracle)
        ref = np.abs(np.asarray(jgtao.gtao_main_window(*jargs))
                     - np.asarray(jgtao.gtao_main_exact(*jargs)))
    print(f"port: max {port.max():.3g}, mean {port.mean():.3g}, over 1e-3 "
          f"{(port > 1e-3).sum()}; vkr_tpu: max {ref.max():.3g}, mean "
          f"{ref.mean():.3g}, over 1e-3 {(ref > 1e-3).sum()}")
    assert ref.max() > 1e-3  # vkr_tpu's max bound does not hold here
    assert port.mean() < 5e-5
    assert port.max() <= ref.max()
    assert (port > 1e-3).sum() <= (ref > 1e-3).sum()
