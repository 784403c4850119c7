"""The port's readback, disk cache and FrameState checkpoints against
vkr_tpu's (core/readback.py, diskcache.py, checkpoint.py), and a frame
resumed from a checkpoint against the uninterrupted one."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkr_tpu.core.checkpoint as jckpt
import vkr_tpu.core.diskcache as jcache
import vkr_tpu.core.readback as jread
from vkr_tpu_torch.core import checkpoint as tckpt
from vkr_tpu_torch.core import diskcache as tcache
from vkr_tpu_torch.core import readback as tread

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


def _image(channels, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (19, 23) if channels == 1 else (19, 23, channels)
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    # past both ends too: save_png clips
    return rng.uniform(-0.1, 1.1, shape).astype(np.float32)


# ------------------------------------------------------------- readback

@pytest.mark.parametrize("srgb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_save_png_pixels_equal_vkr_tpu(tmp_path, channels, dtype, srgb):
    """The port's PNG (written with zlib and struct) decodes, through PIL
    and through the port's decode_png, to the pixels of vkr_tpu's
    PIL-written file."""
    from PIL import Image

    from vkr_tpu_torch.scene.gltf import decode_png

    img = _image(channels, dtype)
    want_path = jread.save_png(jnp.asarray(img), str(tmp_path / "j.png"),
                               srgb_encode=srgb)
    got_path = tread.save_png(torch.from_numpy(img),
                              str(tmp_path / "sub" / "t.png"),
                              srgb_encode=srgb)
    want = np.asarray(Image.open(want_path).convert("RGB"))
    with open(got_path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(
        np.asarray(Image.open(got_path).convert("RGB")), want)
    np.testing.assert_array_equal(decode_png(data)[..., :3], want)
    np.testing.assert_array_equal(
        tread.png_pixels(torch.from_numpy(img), srgb), want)


def test_save_depth_csv_text_equals_vkr_tpu(tmp_path):
    depth = np.random.default_rng(1).uniform(-0.1, 1.1, (7, 13)).astype(
        np.float32)
    depth[0, :3] = [0.0, 1.0, 0.5]
    want = jread.save_depth_csv(jnp.asarray(depth), str(tmp_path / "j.csv"))
    got = tread.save_depth_csv(torch.from_numpy(depth),
                               str(tmp_path / "t.csv"))
    with open(want) as f, open(got) as g:
        assert g.read() == f.read()


def test_to_host_and_capture_path():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    np.testing.assert_array_equal(tread.to_host(t), t.numpy())
    np.testing.assert_array_equal(tread.to_host([1, 2]), np.asarray([1, 2]))
    path = tread.capture_path("frame", "png", "caps")
    assert path.startswith(os.path.join("caps", "frame-"))
    assert path.endswith(".png")


# ----------------------------------------------------------- disk cache

def test_content_key_equals_vkr_tpu():
    parts = (np.arange(12, dtype=np.float32).reshape(3, 4), "ssr-luts", 64,
             1.5, np.zeros((2,), np.int32), None)
    assert tcache.content_key(*parts) == jcache.content_key(*parts)
    assert tcache.content_key(1) != tcache.content_key(2)
    assert tcache.VERSION == jcache.VERSION


def test_cached_npz_round_trip_corrupt_and_off(tmp_path, monkeypatch):
    monkeypatch.setenv("VKR_DISK_CACHE", str(tmp_path))
    builds = []

    def build():
        builds.append(1)
        return {"a": np.arange(5, dtype=np.float32),
                "b": np.ones((2, 2), np.int32)}

    first = tcache.cached_npz("k", build)
    second = tcache.cached_npz("k", build)
    assert len(builds) == 1
    for name in ("a", "b"):
        np.testing.assert_array_equal(second[name], first[name])
        assert second[name].dtype == first[name].dtype
    # vkr_tpu reads the port's entry: one layout
    np.testing.assert_array_equal(jcache.cached_npz("k", build)["a"],
                                  first["a"])
    assert len(builds) == 1
    # a corrupt entry is rebuilt
    entry = tmp_path / f"k-v{tcache.VERSION}"
    (entry / "a.npy").write_bytes(b"not an array")
    again = tcache.cached_npz("k", build)
    assert len(builds) == 2
    np.testing.assert_array_equal(again["a"], first["a"])
    # VKR_DISK_CACHE=0: no cache
    monkeypatch.setenv("VKR_DISK_CACHE", "0")
    tcache.cached_npz("k", build)
    tcache.cached_npz("k", build)
    assert len(builds) == 4


def test_build_ssr_resources_cold_equals_warm(tmp_path, monkeypatch):
    """The LUTs through the disk cache under the port's own key: a warm
    start returns exactly what the cold start built, which equals the
    registered preintegration passes."""
    from vkr_tpu_torch.core import registry
    from vkr_tpu_torch.frame import build_ssr_resources

    monkeypatch.setenv("VKR_DISK_CACHE", str(tmp_path))
    cold = build_ssr_resources(16, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [
        f"ssr-luts-16-vkr_tpu_torch-fma-cpu-v{tcache.VERSION}"]
    warm = build_ssr_resources(16, device="cpu")
    for a, b in zip(cold, warm):
        assert torch.equal(a, b) and a.dtype == b.dtype
    torch.testing.assert_close(
        cold.pdf_lut, registry.get("pdf_preintegrate")(16, device="cpu"),
        rtol=0, atol=0)
    torch.testing.assert_close(
        cold.brdf_lut, registry.get("brdf_preintegrate")(16, device="cpu"),
        rtol=0, atol=0)


# ---------------------------------------------------------- checkpoints

def _state_arrays(seed):
    rng = np.random.default_rng(seed)
    h, w = 8, 12
    return {
        "prev_depth": rng.uniform(0, 1, (h, w)),
        "prev_depth_half": rng.uniform(0, 1, (h // 2, w // 2)),
        "taa_history": rng.uniform(0, 1, (h, w, 3)),
        "gtao_accum": rng.uniform(0, 1, (h // 2, w // 2, 2)),
        "gtao_prev": rng.uniform(0, 1, (h // 2, w // 2)),
        "ssr_history": rng.uniform(0, 1, (h // 2, w // 2, 3)),
        "prev_mvp": rng.uniform(-1, 1, (4, 4)),
    }


def test_checkpoint_vkr_tpu_to_port(tmp_path):
    from vkr_tpu.core.framestate import FrameState as JState

    arrays = {k: jnp.asarray(v, jnp.float32)
              for k, v in _state_arrays(2).items()}
    jstate = JState(frame_index=jnp.asarray(7, jnp.int32), **arrays)
    path = jckpt.save_state(jstate, str(tmp_path / "j.npz"))
    state = tckpt.load_state(path, "cpu")
    assert state.frame_index.dtype == torch.int32
    assert state.frame_index.shape == () and int(state.frame_index) == 7
    for name in arrays:
        got = getattr(state, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(arrays[name]))


def test_checkpoint_port_to_vkr_tpu(tmp_path):
    from vkr_tpu_torch.core.framestate import FrameState

    arrays = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _state_arrays(3).items()}
    state = FrameState(frame_index=torch.tensor(11, dtype=torch.int32),
                       **arrays)
    path = tckpt.save_state(state, str(tmp_path / "dir" / "t.npz"))
    with np.load(path) as data:
        assert data["frame_index"].dtype == np.int32
        assert data["frame_index"].shape == ()
        assert sorted(data.files) == sorted(FrameState.FIELDS)
    jstate = jckpt.load_state(path)
    assert int(jstate.frame_index) == 11
    assert jstate.frame_index.dtype == jnp.int32
    for name, t in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(jstate, name)),
                                      t.numpy())


def test_resumed_frame_equals_uninterrupted(tmp_path):
    """Frames 0-2 of the default frame (SSR on, MIS GTAO) at 64x32 in the
    24-column hall; the FrameState after frame 1 saved, loaded and frame
    2 rendered from it: colour and FrameState bit-equal to the
    uninterrupted frame 2."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    w, h = 64, 32
    cfg = RenderConfig(width=w, height=h)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=16), "cpu")
    res = build_ssr_resources(16, device="cpu")

    def cam(i):
        return camera_frame(cfg, bench_orbit_view(i),
                            bench_orbit_view(max(i - 1, 0)), i, "cpu")

    state = FrameState.initial(h, w, "cpu")
    for i in range(2):
        _, state, _ = render_frame(scene, state, cam(i), res, cfg)
    path = tckpt.save_state(state, str(tmp_path / "state.npz"))
    color, after, _ = render_frame(scene, state, cam(2), res, cfg)
    loaded = tckpt.load_state(path, "cpu")
    color2, after2, _ = render_frame(scene, loaded, cam(2), res, cfg)
    assert torch.equal(color2, color)
    assert after2.frame_index == after.frame_index == 3
    for name in FrameState.FIELDS[:-1]:
        assert torch.equal(getattr(after2, name), getattr(after, name)), name
