"""The passes that no frame calls and that trace the screen: the plain
hi-Z march (no horizon), simple SSR, the SSR tile path (classification,
plane regression, the indirect trace) and the screen-trace trio, each
against vkr_tpu's function on the same inputs.

The G-buffer is the port's: the 24-column colonnade hall (the bench's
geometry at tessellation 4) at 128x64, orbit frame 1, which
test_torch_raster.py holds against vkr_tpu's Pallas-path G-buffer; both
sides start from these arrays. vkr_tpu's march runs as its no-drop oracle
(`_hierarchical_march(..., compact_frac=0.0)`, a test-only patch): its
callers' default compact_frac=0.25 drops rays past the compaction
capacity, and the port drops none (ROADMAP queue 3). The passes whose
rays hash a halton row run jitted on vkr_tpu's side, as vkr_tpu's frame
runs them; the port follows that form of the hash (passes/ssr.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkr_tpu.passes.screen_trace as jst
import vkr_tpu.passes.simple_ssr as jsimple
import vkr_tpu.passes.ssr as jssr
import vkr_tpu.passes.ssr_tiles as jtiles
from vkr_tpu_torch.passes import screen_trace as tst
from vkr_tpu_torch.passes import simple_ssr as tsimple
from vkr_tpu_torch.passes import ssr as tssr
from vkr_tpu_torch.passes import ssr_tiles as ttiles
from vkr_tpu_torch.passes.ssr_march import hierarchical_march_plain

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

W, H = 128, 64


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def no_drop():
    """vkr_tpu's march without compaction drops, in both modules that
    import it (test-only patch)."""
    march = functools.partial(jssr._hierarchical_march, compact_frac=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssr, "_hierarchical_march", march)
        mp.setattr(jsimple, "_hierarchical_march", march)
        yield


@pytest.fixture(scope="module")
def hall():
    """Orbit frame 1 through the port's G-buffer and hi-Z, as numpy arrays,
    with the frame's parameters for both packages."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=32), "cpu")
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1,
                       "cpu")
    g = render_gbuffer(scene, cam.mvp, cam.prev_mvp, cam.jitter, width=W,
                       height=H)
    hiz = build_hiz(g.depth, g.normal, g.velocity)
    nm = _normal_mat4(cam.view).numpy()
    lens = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
                znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    mips = [m.numpy() for m in hiz.mips]
    return dict(
        mips=mips, normal_half=hiz.normal_half.numpy(),
        depth=g.depth.numpy(), normal=g.normal.numpy(),
        material=g.material.numpy(), albedo=g.albedo.numpy(),
        inv_view=_inv4(cam.view).numpy(), nm=nm, lens=lens,
        jpyr=jssr.pack_pyramid([jnp.asarray(m) for m in mips]),
        tpyr=tssr.pack_pyramid([_t(m) for m in mips]),
        jparams=jssr.SSRParams(normal_mat=jnp.asarray(nm), **lens),
        tparams=tssr.SSRParams(normal_mat=_t(nm), **lens))


@pytest.fixture(scope="module")
def halton():
    from vkr_tpu.mathlib.brdf import halton23_table

    return halton23_table(jssr.HALTON_SEQ_SIZE)


# ------------------------------------------------------ the plain march

@pytest.mark.parametrize("mip, iterations", [(0, 50), (1, 25)])
def test_plain_march(hall, mip, iterations):
    """Seeded projective rays over the hall's pyramid, from mip 0 with 50
    iterations (the mirror trace) and from mip 1 with 25 (the glossy
    trace): iters equal on all but 0.1% of the rays, positions of rays
    with equal iters within 1e-5 (measured: iters equal on every ray,
    positions within 1.2e-7)."""
    rng = np.random.default_rng(3 + mip)
    h, w = hall["mips"][0].shape
    origin = np.stack([rng.uniform(0, 1, (h, w)), rng.uniform(0, 1, (h, w)),
                       rng.uniform(0.5, 1, (h, w))], -1).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d = d * ((1.0 - origin[..., 2]) / np.where(np.abs(d[..., 2]) < 1e-3,
                                                1e-3, d[..., 2]))[..., None]
    d = d.astype(np.float32)
    zeros = jnp.zeros((h, w, 3), jnp.float32)
    jpos, _, jit = jssr._hierarchical_march(
        hall["jpyr"], jnp.asarray(origin), jnp.asarray(d), zeros, zeros,
        hall["jparams"], iterations, find_hor=False, compact_frac=0.0,
        most_detailed_mip=mip)
    tpos, tit = hierarchical_march_plain(hall["tpyr"], _t(origin), _t(d),
                                         iterations, most_detailed_mip=mip)
    jpos, jit = np.asarray(jpos), np.asarray(jit)
    assert tit.dtype == torch.int32 and tpos.shape == (h, w, 3)
    same = jit == tit.numpy()
    assert same.mean() >= 0.999
    assert 0.2 < (jit <= iterations).mean() < 0.9  # hits and misses both
    np.testing.assert_allclose(tpos.numpy()[same], jpos[same], rtol=0,
                               atol=1e-5)


def test_find_hor_march_unchanged(hall):
    """The find_hor form (the kernel's plain version) beside the plain form
    it now shares a loop with: vkr_tpu's no-drop find_hor march on seeded
    rays, iters equal on 99.9% and the horizon within 1e-5 where they are
    (tests/test_torch_ssr.py holds it on the frame's rays)."""
    from vkr_tpu_torch.passes.ssr_march import hierarchical_march_reference

    rng = np.random.default_rng(9)
    h, w = hall["mips"][0].shape
    origin = np.stack([rng.uniform(0, 1, (h, w)), rng.uniform(0, 1, (h, w)),
                       rng.uniform(0.5, 1, (h, w))], -1).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    cam = rng.normal(size=(h, w, 3)).astype(np.float32)
    w0 = -cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    jpos, jhor, jit = jssr._hierarchical_march(
        hall["jpyr"], *map(jnp.asarray, (origin, d, cam, w0)),
        hall["jparams"], 40, compact_frac=0.0)
    tpos, thor, tit = hierarchical_march_reference(
        hall["tpyr"], *map(_t, (origin, d, cam, w0)), hall["tparams"], 40)
    same = np.asarray(jit) == tit.numpy()
    assert same.mean() >= 0.999
    np.testing.assert_allclose(thor.numpy()[same], np.asarray(jhor)[same],
                               rtol=0, atol=1e-5)


# ------------------------------------------------------------ simple SSR

def test_simple_ssr(hall, no_drop):
    """The mirror trace of every pixel, reflecting the half-res albedo:
    validity equal on every pixel, and the reflected colour within 5e-4.
    The hit positions agree to float32 rounding (1e-5 of a uv), and a
    bilinear tap at a hit between two texels of the albedo's contrast
    moves the colour by up to 1.8e-4 (measured)."""
    from vkr_tpu.passes.sampling import downsample_full_to_half

    color = np.asarray(downsample_full_to_half(
        jnp.asarray(hall["albedo"][..., :3])))
    want = np.asarray(jax.jit(lambda f, n, c: jsimple.simple_ssr(
        hall["jpyr"]._replace(flat=f), n, c, hall["jparams"]))(
            hall["jpyr"].flat, hall["normal_half"], color))
    got = tsimple.simple_ssr(hall["tpyr"], _t(hall["normal_half"]),
                             _t(color), hall["tparams"]).numpy()
    assert got.shape == want.shape == (H // 2, W // 2, 4)
    valid = want[..., 3] > 0
    assert valid.mean() > 0.05  # the hall's floor and walls hit
    np.testing.assert_array_equal(got[..., 3] > 0, valid)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


# ------------------------------------------------------------ SSR tiles

@pytest.mark.parametrize("args", [(1.0, 0.2), (0.7, 0.3), (1.0, 0.0)])
@pytest.mark.parametrize("res", ["full", "half"])
def test_classify_tiles_exact(hall, args, res):
    """Every field equal, the tile lists' order included (a stable sort by
    class: members first, each in tile order)."""
    mat = hall["material"] if res == "full" else hall["material"][::2, ::2]
    mat = np.ascontiguousarray(mat)
    want = jtiles.classify_tiles(jnp.asarray(mat), *args)
    got = ttiles.classify_tiles(_t(mat), *args)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    count = int(got.reflective_count) + int(got.glossy_count)
    assert count == got.is_reflective.numel()


def test_tile_plane_regression(hall):
    """The 3x3 normal equations of a far tile are near singular (its points
    lie almost along one ray from the eye), so the plane's rounding is
    amplified: vkr_tpu's eager and jitted forms of the same function part
    by 9.1e-3 on the planes (|plane| <= 2.23) and 1.6e-4 on the errors
    here. The port is held to twice that spread of vkr_tpu's own, measured
    in this test, on every tile."""
    args = (hall["lens"]["fovy"], hall["lens"]["aspect"],
            hall["lens"]["znear"], hall["lens"]["zfar"])
    depth, inv = hall["depth"], hall["inv_view"]
    want = np.asarray(jtiles.tile_plane_regression(
        jnp.asarray(depth), jnp.asarray(inv), *args))
    jitted = np.asarray(jax.jit(lambda d, m: jtiles.tile_plane_regression(
        d, m, *args))(depth, inv))
    got = ttiles.tile_plane_regression(_t(depth), _t(inv), *args).numpy()
    assert got.shape == want.shape == (H // 8, W // 8, 4)
    assert np.isfinite(got).all()
    spread = np.abs(want - jitted)
    diff = np.abs(got - want)
    assert diff[..., :3].max() <= 2 * spread[..., :3].max()
    assert diff[..., 3].max() <= 2 * spread[..., 3].max()
    # the bulk agrees far closer: median plane error 6e-4 of |plane|
    rel = diff[..., :3].max(-1) / np.abs(want[..., :3]).max(-1)
    assert np.median(rel) <= 2e-3


def test_tile_regression_nan_error_is_1e10():
    """A NaN error term counts as 1e10, as in vkr_tpu: a tile holding a NaN
    depth has NaN sums, a NaN plane and an error of 1e10 on both sides."""
    depth = np.full((16, 16), 0.5, np.float32)
    depth[3, 12] = np.nan
    args = (np.radians(60), 1.0, 0.05, 80.0)
    want = np.asarray(jtiles.tile_plane_regression(
        jnp.asarray(depth), jnp.eye(4), *args))
    got = ttiles.tile_plane_regression(_t(depth), torch.eye(4),
                                       *args).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 1, :3]).all()
    # the mean of 64 errors of 1e10, summed in float32
    assert got[0, 1, 3] == want[0, 1, 3]
    assert abs(got[0, 1, 3] - 1e10) <= 1e4
    assert np.isfinite(got[1]).all()


@pytest.mark.parametrize("reflection_type", [0, 1])
def test_ssr_trace_indirect(hall, halton, no_drop, reflection_type):
    """Mirror tiles (mip 0, 50 iterations) and glossy tiles (mip 1, 25) of
    a material whose left half is mirror-smooth and right half glossy:
    out-of-class pixels equal (0, 0, 1, 1) on both sides, validity
    agreement >= 0.999, and the hit uv of rays valid in both within one
    texel at p99. As in test_torch_ssr.py::test_ssr_trace, a pixel whose
    halton row differs traces another ray."""
    mat = hall["material"].copy()
    mat[:, : W // 2, 1] = 0.05
    mat[:, W // 2:, 1] = 0.6
    # tiles of the half-res trace, as vkr_tpu's own tests classify them
    half = np.ascontiguousarray(mat[::2, ::2])
    jcls = jtiles.classify_tiles(jnp.asarray(half), 1.0, 0.2)
    tcls = ttiles.classify_tiles(_t(half), 1.0, 0.2)
    want = np.asarray(jax.jit(lambda f, n, m: jtiles.ssr_trace_indirect(
        hall["jpyr"]._replace(flat=f), n, m, hall["jparams"],
        jnp.asarray(1, jnp.uint32), jnp.asarray(halton), jcls,
        reflection_type=reflection_type))(
            hall["jpyr"].flat, hall["normal_half"], mat))
    got = ttiles.ssr_trace_indirect(
        hall["tpyr"], _t(hall["normal_half"]), _t(mat), hall["tparams"], 1,
        _t(halton), tcls, reflection_type=reflection_type).numpy()
    assert got.shape == want.shape == (H // 2, W // 2, 4)
    mask = ttiles.trace_indirect_mask(tcls, H // 2, W // 2).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jtiles.trace_indirect_mask(jcls, H // 2, W // 2)))
    outside = ~mask if reflection_type == 0 else mask
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(got[outside], want[outside])
    vw, vg = want[..., 3] != 1.0, got[..., 3] != 1.0
    assert vw.mean() > 0.01
    assert (vw == vg).mean() >= 0.999
    both = vw & vg
    hit = np.abs(want[..., :2] - got[..., :2])[both].max(-1) * (W // 2)
    assert np.percentile(hit, 99) < 1.0


# ------------------------------------------------------ the screen trace

@pytest.fixture(scope="module")
def screen_traced(hall):
    """screen_trace on the full-res hall with a seeded colour, two
    directions, the top rows turned to sky; vkr_tpu's eagerly (its
    fori_loop compiles the sample loop) and the port's."""
    depth = hall["depth"].copy()
    depth[:6] = 1.0
    color = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    jp = jst.ScreenTraceParams(jnp.asarray(hall["nm"]), **hall["lens"])
    tp = tst.ScreenTraceParams(_t(hall["nm"]), **hall["lens"])
    want = np.asarray(jst.screen_trace(
        jnp.asarray(depth), jnp.asarray(hall["normal"]), jnp.asarray(color),
        jp, angle_offset=0.3, dirs_count=2))
    got = tst.screen_trace(_t(depth), _t(hall["normal"]), _t(color), tp,
                           angle_offset=0.3, dirs_count=2).numpy()
    return depth, want, got


def test_screen_trace(screen_traced):
    """Visibility within 2e-4 everywhere (measured 9e-5). The radiance sums
    the samples that pass a horizon test `s_cos >= h_cos`, which flips on
    a knife edge: within 1e-4 on all but 0.5% of the pixels (measured
    0.2%; vkr_tpu's jitted and eager forms part on 0.18% alike). Sky
    pixels are (0, 0, 0, 1)."""
    depth, want, got = screen_traced
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=0, atol=2e-4)
    off = (np.abs(got - want).max(-1) > 1e-4).mean()
    assert off <= 0.005
    assert want[..., :3].max() > 0.01  # radiance was gathered
    sky = depth >= 1.0
    np.testing.assert_array_equal(got[sky], np.tile([0.0, 0.0, 0.0, 1.0],
                                                    (int(sky.sum()), 1)))


def test_screen_trace_filter_and_accumulate(hall, screen_traced):
    """The 4x4 bilateral filter and the depth-validated accumulation on
    identical inputs: the same float32 ops in the same order, equal."""
    depth, raw, _ = screen_traced
    lens = hall["lens"]
    want = np.asarray(jst.screen_trace_filter(
        jnp.asarray(depth), jnp.asarray(raw), lens["znear"], lens["zfar"]))
    got = tst.screen_trace_filter(_t(depth), _t(raw), lens["znear"],
                                  lens["zfar"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    prev = np.roll(depth, 1, axis=0)
    prev[:8] = depth[:8]
    accum = np.random.default_rng(6).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    args = (lens["fovy"], lens["aspect"], lens["znear"], lens["zfar"])
    wa = np.asarray(jst.screen_trace_accumulate(
        *map(jnp.asarray, (depth, prev, want, accum)), *args))
    ga = tst.screen_trace_accumulate(*map(_t, (depth, prev, want, accum)),
                                     *args).numpy()
    blended = (wa != want).any(-1)
    assert 0.01 < blended.mean() < 1.0  # both branches taken
    np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-6)
