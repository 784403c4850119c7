"""The port's probe GI modules (vkr_tpu_torch/passes/probes.py) against
vkr_tpu's (vkr_tpu/passes/probes.py) on the CPU, on the small colonnade of
tests/test_probes.py. Inputs come from numpy with fixed seeds.

vkr_tpu rasters the cubemap faces through its Pallas path in interpret
mode, eagerly (its oracle raster parts from its Pallas raster on edge
pixels, ROADMAP queue 3); the port's faces run K1's plain version. The
trace is held on a 2x2 grid that vkr_tpu renders and
convert.probe_grid_from_numpy carries across, so both sides march the same
octahedral depth. Measured values print under `pytest -s`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.passes import probes as jp
from vkr_tpu_torch.passes import probes as tp

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

CUBE, OCT = 16, 32
POSITION = (0.0, 2.0, 0.0)
SIZE = 64  # G-buffer of the trace test


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(name, rng):
    """Arguments of `name` as numpy arrays: depths and planar distances in
    range, uv on and off the octant edges, unit directions (axes and
    diagonals included), faces of random colour and distance."""
    if name == "encode_oct_depth":
        return (rng.uniform(0.05, 80.0, 4096),)
    if name == "decode_oct_depth":
        return (rng.uniform(0.0, 1.0, 4096),)
    if name == "oct_center":
        uv = rng.uniform(0.0, 1.0, (1024, 2))
        grid = np.stack(np.meshgrid(np.arange(9) / 8, np.arange(9) / 8), -1)
        return (np.concatenate([uv, grid.reshape(-1, 2)]),)
    dirs = rng.normal(size=(2048, 3))
    axes = np.concatenate([np.eye(3), -np.eye(3), np.ones((1, 3)),
                           -np.ones((1, 3))])
    dirs = np.concatenate([dirs, axes])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    if name in ("oct_encode_dir", "oct_decode_dir"):
        return ((dirs,) if name == "oct_encode_dir"
                else (rng.uniform(0.0, 1.0, (2048, 2)),))
    faces = rng.uniform(0.0, 1.0, (6, 8, 8, 3))
    if name == "sample_cubemap":
        return faces, dirs
    return faces, rng.uniform(1.0, 20.0, (6, 8, 8))   # cube_to_oct


@pytest.mark.parametrize("name", ["encode_oct_depth", "decode_oct_depth",
                                  "oct_center", "oct_encode_dir",
                                  "oct_decode_dir", "sample_cubemap",
                                  "cube_to_oct"])
def test_function_matches_vkr_tpu(name):
    """atol 1e-6, relative for the depth decode (up to 80)."""
    from vkr_tpu.mathlib import octahedral as jo
    from vkr_tpu_torch.mathlib import octahedral as to

    args = [np.asarray(a, np.float32)
            for a in _inputs(name, np.random.default_rng(len(name)))]
    jfn = getattr(jo if name.startswith("oct_") and "dir" in name else jp,
                  name)
    tfn = getattr(to if name.startswith("oct_") and "dir" in name else tp,
                  name)
    kw = {"oct_size": 16} if name == "cube_to_oct" else {}
    want = jfn(*(jnp.asarray(a) for a in args), **kw)
    got = tfn(*(_t(a) for a in args), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def scene_np():
    from vkr_tpu.scene.procedural import colonnade_scene

    return colonnade_scene(columns=2, tessellation=6, tex_size=32,
                           foliage=False)


@pytest.fixture(scope="module")
def faces(scene_np):
    """One probe's cubemap from vkr_tpu (Pallas raster, interpreted) and
    from the port (K1's plain version), from the same position."""
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu_torch.convert import scene_from_numpy

    jscene = j_upload(scene_np)
    jcolor, jdist = jp.render_probe_cubemap(jscene, POSITION, CUBE,
                                            use_pallas=True, interpret=True)
    got = tp.render_probe_cubemap(scene_from_numpy(scene_np, "cpu"),
                                  POSITION, CUBE)
    return jscene, (np.asarray(jcolor), np.asarray(jdist)), got


def test_cubemap_distance_equal(faces):
    _, (_, jdist), (_, dist, _, _) = faces
    dist = dist.numpy()
    covered = (jdist < 100.0) | (dist < 100.0)
    equal = float((dist[covered] == jdist[covered]).mean())
    print(f"cubemap: covered {covered.mean():.4f}, distance equal on "
          f"{equal:.6f} of it, max |diff| "
          f"{np.abs(dist - jdist)[covered].max():.3g}")
    assert covered.mean() > 0.5
    assert equal >= 0.999


def test_cubemap_colour_psnr(faces):
    _, (jcolor, _), (color, _, _, _) = faces
    value = psnr(color.numpy(), jcolor)
    print(f"cubemap colour: {value:.2f} dB")
    assert color.shape == (6, CUBE, CUBE, 3)
    assert value >= 40.0


def test_cubemap_faces_drop_nothing(faces):
    _, (_, jdist), (_, _, overflow, coverage) = faces
    assert overflow.tolist() == [0] * 6
    np.testing.assert_allclose(coverage.numpy(),
                               (jdist < 100.0).mean(axis=(1, 2)), atol=0.01)


def test_oct_depth_pyramid_bit_equal(faces):
    """cube_to_oct and the min pyramid on vkr_tpu's faces, carried across:
    the same octahedral map and every mip bit for bit."""
    _, (jcolor, jdist), _ = faces
    jc, jd = jp.cube_to_oct(jnp.asarray(jcolor), jnp.asarray(jdist), OCT)
    tc, td = tp.cube_to_oct(_t(jcolor), _t(jdist), OCT)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    want = jp.oct_depth_pyramid(jd)
    got = tp.oct_depth_pyramid(td)
    assert [m.shape[0] for m in got] == [OCT >> i for i in range(6)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def trace(faces, scene_np):
    """vkr_tpu's 2x2 grid, carried across, traced by both sides from the
    port's G-buffer of tests/test_probes.py's camera."""
    from vkr_tpu.mathlib import look_at, perspective
    from vkr_tpu.mathlib.transforms import inverse_rigid
    from vkr_tpu_torch.convert import probe_grid_from_numpy, scene_from_numpy
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer

    jscene = faces[0]
    jgrid = jp.render_probe_grid(jscene, (-2, 1.5, -2), (2, 1.5, 2),
                                 grid_size=2, cube_size=CUBE, oct_size=OCT,
                                 use_pallas=True, interpret=True)
    grid = probe_grid_from_numpy(jgrid, "cpu")
    view = look_at((0, 1.2, -3), (0, 1.0, 1), (0, -1, 0))
    fovy = math.radians(60.0)
    vp = _t(perspective(fovy, 1.0, 0.05, 80.0) @ view)
    g = render_gbuffer(scene_from_numpy(scene_np, "cpu"), vp, vp,
                       torch.zeros(2), width=SIZE, height=SIZE)
    inv = np.asarray(inverse_rigid(view), np.float32)
    # jitted: compiling the 16 marches once is faster than running them
    # eagerly
    want = np.asarray(jax.jit(lambda d, n, i: jp.probe_trace(
        d, n, jgrid, i, fovy, 1.0, 0.05, 80.0))(
        jnp.asarray(g.depth.numpy()), jnp.asarray(g.normal.numpy()),
        jnp.asarray(inv)))
    got = tp.probe_trace(g.depth, g.normal, grid, _t(inv), fovy, 1.0, 0.05,
                         80.0).numpy()
    return jgrid, grid, want, got


def test_probe_grid_carried_across(trace):
    jgrid, grid, _, _ = trace
    assert grid.mip_offsets == tuple(jgrid.mip_offsets)
    assert grid.mip_sizes == tuple(jgrid.mip_sizes) == (32, 16, 8, 4, 2, 1)
    assert grid.grid_size == 2 and grid.face_overflow is None
    np.testing.assert_array_equal(grid.depth_flat.numpy(),
                                  np.asarray(jgrid.depth_flat))


def test_probe_trace_result_codes(trace):
    """The pixel's outcome (a probe hit, or none) agrees on >= 0.995."""
    _, _, want, got = trace
    agree = float(((got[..., 3] > 0) == (want[..., 3] > 0)).mean())
    hits = float((got[..., 3] > 0).mean())
    print(f"probe trace: hits {hits:.4f} of the pixels, outcome agreement "
          f"{agree:.6f}")
    assert hits > 0.1
    assert agree >= 0.995


def test_probe_trace_rgba_psnr(trace):
    _, _, want, got = trace
    value = psnr(got, want)
    print(f"probe trace RGBA: {value:.2f} dB")
    assert got.shape == (SIZE, SIZE, 4) and np.isfinite(got).all()
    assert value >= 40.0


def test_port_grid_on_the_cpu(scene_np):
    """The port's own grid: shapes, packed mip tables, faces that drop
    nothing, and the start-up's launches counted nowhere on the CPU."""
    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.convert import scene_from_numpy

    before = sum(kernels.LAUNCHES.values())
    grid = tp.render_probe_grid(scene_from_numpy(scene_np, "cpu"),
                                (-2, 1.5, -2), (2, 1.5, 2), grid_size=2,
                                cube_size=CUBE, oct_size=OCT)
    assert sum(kernels.LAUNCHES.values()) == before
    assert grid.colors.shape == (4, OCT, OCT, 3)
    assert grid.mip_offsets == (0, 1024, 1280, 1344, 1360, 1364)
    assert grid.depth_flat.shape == (4, 1365)
    assert grid.face_overflow.shape == (4, 6)
    assert int(grid.face_overflow.max()) == 0
    assert float(grid.face_coverage.min()) > 0.5
