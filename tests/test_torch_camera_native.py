"""scene/camera.py, native/ (the asset pipeline's C++ library and its ctypes
loader), scene.py's use of it, and core/platform.py of vkr_tpu_torch
against vkr_tpu's counterparts, on the CPU.

vkr_tpu's library is built here with `make -C vkr_tpu/native`, as
tests/test_native.py builds it. The three implementations of each image
entry point (the port's library, its numpy plain version, vkr_tpu's
library) agree byte for byte: the plain versions reproduce the compiler's
fma contraction under -march=native on an x86-64 with FMA. The port's
transform_points equals vkr_tpu's in float32 exactly."""

import os
import subprocess

import numpy as np
import pytest
import torch

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "vkr_tpu", "native")
# (height, width, size) of the resize cases: odd, non-square, up and down
RESIZES = ((37, 53, 32), (64, 48, 32), (16, 16, 16), (7, 13, 32),
           (300, 17, 64), (64, 64, 24))
N_STEPS = 50

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vkr_native():
    subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                   capture_output=True)
    from vkr_tpu import native

    native._lib = None  # load the library just built
    assert native.available()
    return native


def test_camera_follows_vkr_tpu():
    """50 seeded rotate and move calls: position, basis and view matrix
    within 1e-6 of vkr_tpu's Camera after every call."""
    from vkr_tpu.scene.camera import Camera as JCamera
    from vkr_tpu_torch.scene import Camera

    rng = np.random.default_rng(7)
    kw = dict(position=(-8.0, 2.2, -2.0), yaw=12.5, pitch=-3.0)
    cam, jcam = Camera(**kw), JCamera(**kw)
    cam.speed = jcam.speed = 11.0
    for _ in range(N_STEPS):
        if rng.random() < 0.5:
            dx, dy = rng.uniform(-40, 40, 2)
            cam.rotate(dx, dy)
            jcam.rotate(dx, dy)
        else:
            dt = float(rng.uniform(0, 0.1))
            f, u, s = rng.integers(-1, 2, 3)
            cam.move(dt, forward=f, up=u, strafe=s)
            jcam.move(dt, forward=f, up=u, strafe=s)
        for name in ("pos", "front", "right", "up"):
            np.testing.assert_allclose(getattr(cam, name),
                                       getattr(jcam, name), atol=1e-6,
                                       err_msg=name)
        np.testing.assert_allclose(cam.view_matrix(), jcam.view_matrix(),
                                   atol=1e-6)
    assert -89.0 <= cam.pitch <= 89.0


@pytest.mark.parametrize("h,w,size", RESIZES)
def test_resize_three_ways(vkr_native, h, w, size):
    from vkr_tpu_torch import native
    from vkr_tpu_torch.scene.scene import _resize_rgba, _resize_rgba_plain

    img = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 4),
                                                       np.uint8)
    got = native.resize_rgba8(img, size, size)
    np.testing.assert_array_equal(got, _resize_rgba_plain(img, size))
    np.testing.assert_array_equal(got, vkr_native.resize_rgba8(img, size,
                                                               size))
    np.testing.assert_array_equal(_resize_rgba(img, size), got)


@pytest.mark.parametrize("n,size", [(3, 16), (2, 32), (1, 64)])
def test_mip_pyramid_three_ways(vkr_native, n, size):
    from vkr_tpu.scene.scene import build_mip_pyramid as j_build
    from vkr_tpu_torch import native
    from vkr_tpu_torch.scene.scene import (build_mip_pyramid,
                                           build_mip_pyramid_plain)

    tex = np.random.default_rng(size).integers(0, 256, (n, size, size, 4),
                                               np.uint8)
    np.testing.assert_array_equal(native.mip_downsample_rgba8(tex),
                                  vkr_native.mip_downsample_rgba8(tex))
    got = build_mip_pyramid(tex)
    assert [m.shape[1] for m in got] == [size >> i for i in range(len(got))]
    for a, b, c in zip(got, build_mip_pyramid_plain(tex), j_build(tex)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("n", [1, 7, 17, 1000, 4099])
def test_transform_points_matches_vkr_tpu(vkr_native, n):
    from vkr_tpu_torch import native

    rng = np.random.default_rng(n)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    pts = (rng.normal(size=(n, 3)) * rng.uniform(0.01, 1000)).astype(
        np.float32)
    got = native.transform_points(m, pts)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vkr_native.transform_points(m, pts))
    np.testing.assert_allclose(got, pts @ m[:3, :3].T + m[:3, 3],
                               rtol=1e-5, atol=1e-3)


def test_scene_compiles_through_the_library(monkeypatch):
    """compile_scene's mips and resizes go through the library, and equal
    what the numpy plain versions give."""
    from vkr_tpu_torch import native
    from vkr_tpu_torch.scene import scene as S
    from vkr_tpu_torch.scene.procedural import build_colonnade

    calls = []
    for name in ("mip_downsample_rgba8", "resize_rgba8"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    gltf = build_colonnade(2, 4, 48)
    got = S.compile_scene(gltf, tex_size=32)
    assert "mip_downsample_rgba8" in calls and "resize_rgba8" in calls
    monkeypatch.setattr(S, "build_mip_pyramid", S.build_mip_pyramid_plain)
    monkeypatch.setattr(S, "_resize_rgba", S._resize_rgba_plain)
    want = S.compile_scene(gltf, tex_size=32)
    assert len(got.tex_mips) == len(want.tex_mips) == 6
    for a, b in zip(got.tex_mips, want.tex_mips):
        np.testing.assert_array_equal(a, b)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    a missing compiler raises naming it. Nothing falls back."""
    from vkr_tpu_torch import native

    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int vkr_native_abi_version() { return }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_path_keys_source_flags_and_host(monkeypatch, tmp_path):
    from vkr_tpu_torch import native

    path = native.library_path()
    assert path.parent == native.BUILD
    assert path.name.startswith("libvkr_native-") and path.suffix == ".so"
    other = tmp_path / "asset_pipeline.cpp"
    other.write_bytes(native.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(native, "SOURCE", other)
    assert native.library_path().name != path.name


def test_ensure_platform_order(monkeypatch):
    """The argument, then VKR_PLATFORM, then cuda; cuda without a card
    raises and names VKR_PLATFORM=cpu."""
    from vkr_tpu_torch.core import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VKR_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="VKR_PLATFORM=cpu"):
        platform.ensure_platform()
    assert platform.ensure_platform("cpu") == torch.device("cpu")
    monkeypatch.setenv("VKR_PLATFORM", "cpu")
    assert platform.ensure_platform() == torch.device("cpu")
    for name in ("cuda", "gpu"):
        with pytest.raises(RuntimeError, match="VKR_PLATFORM=cpu"):
            platform.ensure_platform(name)
        monkeypatch.setenv("VKR_PLATFORM", name)
        with pytest.raises(RuntimeError, match="VKR_PLATFORM=cpu"):
            platform.ensure_platform()
        assert platform.ensure_platform("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        platform.ensure_platform("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("VKR_PLATFORM", "gpu")
    assert platform.ensure_platform() == torch.device("cuda")


def test_host_fingerprint_is_vkr_tpus():
    from vkr_tpu.core.platform import host_fingerprint as j_fingerprint
    from vkr_tpu_torch.core.platform import host_fingerprint

    assert host_fingerprint() == j_fingerprint()
    assert host_fingerprint().startswith("_") and len(host_fingerprint()) == 9
