"""The public helpers vkr_tpu exports and no frame calls, the AOT analog
and the registry's jit names, and the PDF LUT at 256, each held to
vkr_tpu on the CPU.

Helpers: mathlib's exports (encode_depth, perspective_vk, inverse_rigid,
oct_encode_dir/oct_decode_dir), passes/sampling.py's nearest_sample and
texel_fetch, raster/resolve.py's corner_attributes_pre, raster's
re-exports (bin_triangles included) and native.available(). The AOT
analog (core/aot.py:cached_jit) returns the frame function itself: on the
small CPU frame its result equals the direct call, and it builds the CUDA
kernels and the native library only for CUDA arguments. track_jit and
clear_jit_caches act as vkr_tpu's do in tests/test_aux.py."""

import ast
import functools
import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exported(init_path):
    """The names an __init__.py imports from its submodules."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("package", ["mathlib", "raster"])
def test_exports_are_vkr_tpus(package):
    """Every name vkr_tpu's package __init__ exports, the port's exports
    too, as the same kind of object."""
    want = _exported(os.path.join(REPO, "vkr_tpu", package, "__init__.py"))
    jmod = importlib.import_module(f"vkr_tpu.{package}")
    tmod = importlib.import_module(f"vkr_tpu_torch.{package}")
    assert want and set(want) <= set(_exported(
        os.path.join(REPO, "vkr_tpu_torch", package, "__init__.py")))
    for name in want:
        assert callable(getattr(tmod, name)) == callable(
            getattr(jmod, name)), name


def test_encode_depth():
    """gbuffer_encode.glsl's encode_depth on seeded view depths, and the
    round trip through linearize_depth."""
    from vkr_tpu.mathlib import projection as jproj
    from vkr_tpu_torch.mathlib import encode_depth, linearize_depth

    z = -np.random.default_rng(0).uniform(0.06, 79.0, 4096).astype(
        np.float32)
    for znear, zfar in ((0.05, 80.0), (0.1, 1000.0)):
        want = np.asarray(jproj.encode_depth(jnp.asarray(z), znear, zfar))
        got = encode_depth(torch.from_numpy(z), znear, zfar).numpy()
        np.testing.assert_array_equal(got, want)
        back = linearize_depth(torch.from_numpy(got), znear, zfar).numpy()
        np.testing.assert_allclose(back, z, rtol=2e-3)


def test_perspective_vk_and_inverse_rigid():
    """The numpy matrix helpers equal vkr_tpu's; inverse_rigid inverts a
    look-at view."""
    from vkr_tpu.mathlib import transforms as jt
    from vkr_tpu_torch.mathlib import transforms as tt

    assert tt.perspective is tt.perspective_vk
    rng = np.random.default_rng(1)
    for _ in range(8):
        lens = (rng.uniform(0.3, 1.6), rng.uniform(0.5, 2.5),
                rng.uniform(0.01, 1.0), rng.uniform(50.0, 500.0))
        np.testing.assert_array_equal(tt.perspective_vk(*lens),
                                      jt.perspective_vk(*lens))
        eye, center = rng.normal(size=3) * 5, rng.normal(size=3)
        view = tt.look_at(eye, center, (0.0, -1.0, 0.0))
        got = tt.inverse_rigid(view)
        np.testing.assert_array_equal(got, jt.inverse_rigid(view))
        np.testing.assert_allclose(got @ view, np.eye(4), atol=1e-5)


def test_oct_dir():
    """The probe-space names of the octahedral mapping, against vkr_tpu's
    on seeded directions (encode) and seeded uvs (decode)."""
    from vkr_tpu.mathlib import octahedral as jo
    from vkr_tpu_torch.mathlib import oct_decode_dir, oct_encode_dir

    rng = np.random.default_rng(2)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = rng.random((2048, 2)).astype(np.float32)
    np.testing.assert_allclose(
        oct_encode_dir(torch.from_numpy(d)).numpy(),
        np.asarray(jo.oct_encode_dir(jnp.asarray(d))), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        oct_decode_dir(torch.from_numpy(uv)).numpy(),
        np.asarray(jo.oct_decode_dir(jnp.asarray(uv))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [0, 3])
def test_nearest_sample_and_texel_fetch(channels):
    """texelFetch-style taps with clamp-to-edge, uvs and texels outside
    the image included, with and without offsets; (H, W) and (H, W, C)."""
    from vkr_tpu.passes import sampling as js
    from vkr_tpu_torch.passes import sampling as ts

    rng = np.random.default_rng(3 + channels)
    shape = (13, 21) + ((channels,) if channels else ())
    img = rng.random(shape).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (17, 9, 2)).astype(np.float32)
    timg, tuv = torch.from_numpy(img), torch.from_numpy(uv)
    for off in (None, (2, -3)):
        np.testing.assert_array_equal(
            ts.nearest_sample(timg, tuv, off).numpy(),
            np.asarray(js.nearest_sample(jnp.asarray(img), jnp.asarray(uv),
                                         off)))
    x = rng.integers(-5, 30, (6, 7)).astype(np.int32)
    y = rng.integers(-5, 20, (6, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        ts.texel_fetch(timg, torch.from_numpy(x), torch.from_numpy(y))
        .numpy(),
        np.asarray(js.texel_fetch(jnp.asarray(img), jnp.asarray(x),
                                  jnp.asarray(y))))


def test_corner_attributes_pre():
    """Two clipped triangles per source triangle weighted from its own
    corners: the port's row-major form over pair_rows'
    corner_attributes_pre_t, against vkr_tpu's."""
    from vkr_tpu.raster import resolve as jr
    from vkr_tpu_torch.raster.resolve import corner_attributes_pre

    rng = np.random.default_rng(4)
    attr = rng.normal(size=(37, 3, 5)).astype(np.float32)
    weights = rng.random((74, 3, 3)).astype(np.float32)
    got = corner_attributes_pre(torch.from_numpy(attr),
                                torch.from_numpy(weights)).numpy()
    want = np.asarray(jr.corner_attributes_pre(jnp.asarray(attr),
                                               jnp.asarray(weights)))
    assert got.shape == want.shape == (74, 3, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bin_triangles():
    """raster.bin_triangles on a row-major setup: vkr_tpu's segment
    layout, starts, counts and overflow at a capacity that fits and at
    one that drops pairs."""
    from vkr_tpu.raster import setup as jsetup
    from vkr_tpu_torch.raster import TriangleSetup, bin_triangles

    rng = np.random.default_rng(5)
    n, width, height = 60, 96, 40
    x0 = rng.integers(0, width, n)
    y0 = rng.integers(0, height, n)
    bbox = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, 30, n),
                                        width - 1),
                     np.minimum(y0 + rng.integers(0, 20, n), height - 1)],
                    -1).astype(np.int32)
    valid = rng.random(n) < 0.8
    zeros = np.zeros((n, 3), np.float32)
    jst = jsetup.TriangleSetup(*(jnp.asarray(zeros),) * 4,
                               jnp.zeros(n, jnp.float32),
                               jnp.asarray(zeros), jnp.asarray(valid),
                               jnp.asarray(bbox))
    tst = TriangleSetup(*(torch.from_numpy(zeros),) * 4, torch.zeros(n),
                        torch.from_numpy(zeros), torch.from_numpy(valid),
                        torch.from_numpy(bbox))
    for cap in (4096, 20):
        want = jsetup.bin_triangles(jst, width, height, 8, 32, cap)
        got = bin_triangles(tst, width, height, 8, 32, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0


def test_native_available(monkeypatch):
    """native.available(): True where the library builds and loads (as
    vkr_tpu's is once built), False where the build fails."""
    from vkr_tpu_torch import native

    assert native.available()

    def fail():
        raise RuntimeError("native asset pipeline: c++ failed")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    assert not native.available()


# --------------------------------------------------------------- the AOT analog

@pytest.fixture(scope="module")
def small_frame():
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import build_ssr_resources, camera_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=48, height=24)
    scene = upload_scene(colonnade_scene(columns=2, tessellation=6,
                                         tex_size=32), "cpu")
    res = build_ssr_resources(16, device="cpu")
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1,
                       "cpu")
    return scene, FrameState.initial(24, 48, "cpu"), cam, res, cfg


def test_cached_jit_equals_the_frame(small_frame, monkeypatch):
    """On CPU arguments cached_jit builds nothing (the plain versions are
    the CPU's path) and its frame equals the direct call bit for bit,
    with VKR_AOT=0 too."""
    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.core.aot import cached_jit
    from vkr_tpu_torch.core.graph import _leaves
    from vkr_tpu_torch.frame import render_frame

    def tensors(out):
        return [t for t in _leaves(out) if isinstance(t, torch.Tensor)]

    def no_build(*a, **k):
        raise AssertionError("cached_jit built the kernels for CPU tensors")
    monkeypatch.setattr(kernels, "build", no_build)
    direct = tensors(render_frame(*small_frame))
    for aot in ("1", "0"):
        monkeypatch.setenv("VKR_AOT", aot)
        frame = cached_jit("render_frame", render_frame, small_frame,
                           donate_argnums=(1,), extra_key="cpu")
        via = tensors(frame(*small_frame))
        assert len(via) == len(direct) > 10
        for a, b in zip(via, direct):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_cached_jit_builds_for_cuda_arguments(monkeypatch, capsys):
    """Arguments on the card: the kernel libraries and the native library
    are built and loaded before the captured frame is returned (verbose
    says so on stderr); VKR_AOT=0 skips that, and the frame is captured
    all the same (a CapturedFrame, not fn)."""
    from vkr_tpu_torch import kernels, native
    from vkr_tpu_torch.core import aot

    calls = []
    monkeypatch.setattr(aot, "_leaves", lambda tree: [
        types.SimpleNamespace(is_cuda=True)])
    monkeypatch.setattr(kernels, "build", lambda: calls.append("build"))
    monkeypatch.setattr(kernels, "library", lambda n: calls.append(n))
    monkeypatch.setattr(native, "load", lambda: calls.append("native"))

    def fn(x):
        return x + 1
    monkeypatch.setenv("VKR_AOT", "0")
    frame = aot.cached_jit("f", fn, (None,), verbose=True)
    assert isinstance(frame, aot.CapturedFrame) and frame.fn is fn
    assert calls == []
    monkeypatch.setenv("VKR_AOT", "1")
    frame = aot.cached_jit("f", fn, (None,), verbose=True)
    assert isinstance(frame, aot.CapturedFrame) and frame.fn is fn
    assert calls == ["build", *kernels.SOURCES, "native"]
    assert "aot: f: CUDA kernels" in capsys.readouterr().err


def test_track_jit_hot_reload(tmp_path):
    """tests/test_aux.py's hot reload with the port's registry: a frame
    tracked with track_jit sees an edited pass after reload()."""
    from vkr_tpu_torch.core import registry

    mod_path = tmp_path / "hot_jit_pass_mod.py"
    source = ("from vkr_tpu_torch.core.registry import register\n"
              "@register('hot_jit_test_pass')\n"
              "def run(x):\n"
              "    return x * {}\n")
    mod_path.write_text(source.format(2))
    sys.path.insert(0, str(tmp_path))
    frame = None
    try:
        import hot_jit_pass_mod  # noqa: F401

        frame = registry.track_jit(
            lambda x: registry.get("hot_jit_test_pass")(x))
        x = torch.ones(8)
        assert float(frame(x)[0]) == 2.0
        # another length too: a .pyc of the same second and size is reused
        mod_path.write_text(source.format("(2 + 1)"))
        importlib.invalidate_caches()
        assert "hot_jit_pass_mod" in registry.reload("hot_jit_pass_mod")
        assert float(frame(x)[0]) == 3.0
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_jit_pass_mod", None)
        registry._REGISTRY.pop("hot_jit_test_pass", None)
        if frame is not None:
            registry._TRACKED_JITS.discard(frame)


def test_clear_jit_caches_empties_tracked_caches():
    """clear_jit_caches() empties what track_jit tracks, as
    clear_caches() does."""
    from vkr_tpu_torch.core import registry

    @functools.lru_cache(maxsize=None)
    def table(n):
        return torch.arange(n)

    registry.track_jit(table)
    try:
        table(4)
        assert table.cache_info().currsize == 1
        registry.clear_jit_caches()
        assert table.cache_info().currsize == 0
    finally:
        registry._TRACKED_JITS.discard(table)


# ----------------------------------------------------------------- the PDF LUT

def test_preintegrate_pdf_256():
    """The repaired LUT at 256: every texel finite on both sides, held to
    vkr_tpu's jitted LUT with test_torch_ssr.py's bounds at 64."""
    from vkr_tpu.passes import ssr as jssr
    from vkr_tpu_torch.passes import ssr as tssr

    want = np.asarray(jax.jit(jssr.preintegrate_pdf, static_argnums=0)(256))
    got = tssr.preintegrate_pdf(256, device="cpu").numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.median(rel) <= 1e-6 and np.percentile(rel, 99) <= 5e-3
    assert (got == want).mean() >= 0.999
