"""The port's tools (vkr_tpu_torch/tools) on the CPU: render's kernel
frame and presets, scene_info against vkr_tpu's, parity, profile, the
viewer driven over HTTP on a thread, showcase, and core/readback's
LANCZOS downscale and GIF writer against PIL. render's oracle frame
against vkr_tpu's is tests/test_torch_tools_render.py."""

import io
import json
import math
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke

SMALL = ["--tex-size", "32", "--lut-size", "32"]
MIN_PSNR_DB = 40.0
# profile's passes, in vkr_tpu's order
PASSES = ("gbuffer", "hiz", "ssr_trace", "ssr_filter", "ssr_blur",
          "gtao_window", "gtao_filter", "gtao_accum", "shading", "taa")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("VKR_PLATFORM", "cpu")
    monkeypatch.setenv("VKR_DISK_CACHE", str(tmp_path / "cache"))


def psnr(a, b, peak=255.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def test_render_kernel_path(tmp_path):
    """The default (kernel) frame renders too."""
    from vkr_tpu_torch.tools import render

    res = render.main(["--scene", "colonnade", "--size", "32", *SMALL,
                       "--out", str(tmp_path / "k.png"), "--show", "depth"])
    assert res["coverage"] > 0.9
    assert np.asarray(Image.open(tmp_path / "k.png")).shape == (32, 32, 3)


@pytest.mark.parametrize("name,asset", [("suzanne", "suzanne/Suzanne.gltf"),
                                        ("fox", "fox/Fox.gltf")])
def test_preset_assets_come_from_vkr_assets(tmp_path, monkeypatch, name,
                                            asset):
    """A reference preset fails naming VKR_ASSETS when it is unset, and
    naming the path when its file is not under it."""
    from vkr_tpu_torch.tools import render

    monkeypatch.delenv("VKR_ASSETS", raising=False)
    with pytest.raises(FileNotFoundError, match="VKR_ASSETS"):
        render.load_preset(name, 32)
    monkeypatch.setenv("VKR_ASSETS", str(tmp_path / "assets"))
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "assets" / asset))):
        render.load_preset(name, 32)


def test_scene_info_prints_vkr_tpus_lines(tmp_path, capsys):
    from vkr_tpu.tools import scene_info as j_info
    from vkr_tpu_torch.scene.procedural import build_colonnade
    from vkr_tpu_torch.tools import scene_info

    sc = build_colonnade(columns=4, tessellation=6, tex_size=16)
    path = chip_smoke.write_gltf(str(tmp_path), sc, list(sc.images),
                                 [0] * len(sc.images))
    assert j_info.main([path]) == 0
    want = capsys.readouterr().out
    assert scene_info.main([path]) == 0
    got = capsys.readouterr().out
    print(got)
    assert got == want
    assert len(got.splitlines()) == 6
    assert scene_info.main([]) == 1


def test_parity_report(capsys):
    """parity at 64x64 on the colonnade prints vkr_tpu's keys, every figure
    finite and within 0.5 dB of the figures pinned here (the CPU run's,
    chip_smoke.PARITY_64_CPU_DB; the kernels' plain versions run here)."""
    from vkr_tpu_torch.tools import parity

    got = parity.main(["--scene", "colonnade", "--size", "64"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(line)["psnr_kernels_vs_oracle_db"]
    assert report == got
    assert tuple(report) == ("albedo", "normal", "depth", "velocity",
                             "material", "ao", "ssr", "color")
    pinned = chip_smoke.PARITY_64_CPU_DB
    for key, db in report.items():
        assert math.isfinite(db), key
        assert abs(db - pinned[key]) <= 0.5, (key, db, pinned[key])


def test_profile_prints_the_ten_passes(capsys, monkeypatch, tmp_path):
    """The ten passes on the colonnade; --scene sponza fails naming
    VKR_ASSETS when it is unset, and with it set to
    chip_smoke.write_sponza_standin's stand-in profiles
    sponza_colonnade_scene as vkr_tpu's profile asks for it (24 columns,
    tessellation 80, --tex-size). On the CPU the call is answered with
    the stand-in hall at 4 columns and tessellation 8: the plain
    G-buffer of the 314,988 triangles takes over a minute here."""
    from vkr_tpu_torch.scene import procedural
    from vkr_tpu_torch.tools import profile

    monkeypatch.delenv("VKR_ASSETS", raising=False)
    with pytest.raises(FileNotFoundError, match="VKR_ASSETS"):
        profile.main(["--scene", "sponza"])
    capsys.readouterr()
    small = ["--width", "64", "--height", "64", "--reps", "1", *SMALL]
    times = profile.main([*small, "--columns", "4", "--tessellation", "8"])
    out = capsys.readouterr().out
    names = [ln.split()[0] for ln in out.splitlines()[1:]]
    assert tuple(names) == PASSES == tuple(times)
    assert all(t > 0 for t in times.values())

    chip_smoke.write_sponza_standin(str(tmp_path), seed=0, size_scale=1 / 32)
    monkeypatch.setenv("VKR_ASSETS", str(tmp_path))
    asked, built = [], []
    full = procedural.sponza_colonnade_scene

    def smaller(columns, tessellation, tex_size):
        asked.append((columns, tessellation, tex_size))
        built.append(full(columns=4, tessellation=8, tex_size=tex_size))
        return built[-1]

    monkeypatch.setattr(procedural, "sponza_colonnade_scene", smaller)
    times = profile.main(["--scene", "sponza", *small])
    out = capsys.readouterr().out
    names = [ln.split()[0] for ln in out.splitlines()[1:]]
    assert tuple(names) == PASSES == tuple(times)
    assert all(t > 0 for t in times.values())
    assert asked == [(24, 80, 32)]
    assert built[0].tex_mips[0].shape == (69, 32, 32, 4)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_viewer_over_http(monkeypatch):
    """The viewer on a thread: the page, a PNG frame at the viewer's size,
    the stats, and a POSTed slider, toggle and `j` reaching the next
    frame's Tuning, RenderConfig and jitter."""
    from vkr_tpu_torch import frame as F
    from vkr_tpu_torch.tools import viewer

    seen = []
    go = [threading.Event() for _ in range(3)]
    render_frame = F.render_frame

    def gated(scene, state, cam, res, cfg, **kw):
        i = len(seen)
        seen.append((kw["tuning"], cfg, cam.jitter.clone()))
        go[i].wait(60)
        return render_frame(scene, state, cam, res, cfg, **kw)

    monkeypatch.setattr(F, "render_frame", gated)
    port = _free_port()
    result = {}
    th = threading.Thread(target=lambda: result.setdefault(
        "ms", viewer.main(["--max-frames", "3", "--port", str(port),
                           "--width", "48", "--height", "32",
                           "--columns", "2", *SMALL])), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(600):
        try:
            page = urllib.request.urlopen(base + "/").read().decode()
            break
        except OSError:
            time.sleep(0.1)
    assert 'id="view" width="48" height="32"' in page
    for _ in range(600):  # frame 0 has read its input and waits
        if seen:
            break
        time.sleep(0.1)

    def post(msg):
        urllib.request.urlopen(urllib.request.Request(
            base + "/input", data=json.dumps(msg).encode(),
            method="POST")).read()

    post({"slider": {"weight_ratio": 2.5, "ssr_temporal_rays": 4}})
    post({"toggle": "2"})
    post({"toggle": "j"})
    post({"toggle": "r"})
    go[0].set()
    png = urllib.request.urlopen(base + "/frame.png?since=0").read()
    assert Image.open(io.BytesIO(png)).size == (48, 32)
    stats = json.loads(urllib.request.urlopen(base + "/stats").read())
    assert stats["frame"] >= 1 and not stats["ssr"] and not stats["jitter"]
    go[1].set()
    go[2].set()
    th.join(120)
    assert not th.is_alive() and len(result["ms"]) == 3
    first, later = seen[0], seen[1]
    assert later[0] == F.Tuning(2.5, 1.0, 0.0, 1.0, 4)
    assert first[1].enable_ssr and not later[1].enable_ssr
    assert bool(first[2].abs().sum() > 0)
    assert torch.equal(later[2], torch.zeros(2))


def test_showcase_writes_gif_and_still(tmp_path, monkeypatch):
    from vkr_tpu_torch.tools import showcase

    # a small hall: the scene sizes are the module's constants
    for name, value in (("COLUMNS", 4), ("TESSELLATION", 8),
                        ("TEX_SIZE", 32), ("LUT_SIZE", 32)):
        monkeypatch.setattr(showcase, name, value)
    res = showcase.main(["--out-dir", str(tmp_path), "--frames", "12",
                         "--width", "96", "--height", "54"])
    still = np.asarray(Image.open(tmp_path / "colonnade_final.png"))
    assert still.shape == (54, 96, 3)
    gif = Image.open(tmp_path / "colonnade_orbit.gif")
    n_kept = len(range(showcase.SKIP, 12)[::2])
    assert gif.n_frames == n_kept == len(res["frames"])
    assert gif.size == (32, 18)
    # GIF delays are hundredths of a second: 66 ms is written as 6, as
    # PIL writes it, and reads back as 60 ms
    assert gif.info["duration"] == 10 * (showcase.DURATION_MS // 10)
    assert gif.info["loop"] == 0
    for i, want in enumerate(res["frames"]):
        gif.seek(i)
        got = np.asarray(gif.convert("RGB")).astype(int)
        err = np.abs(got - want).mean()
        print(f"gif frame {i}: mean |d| {err:.3f}")
        assert err < 6.0


def test_lanczos_resize_against_pil():
    from vkr_tpu_torch.core.readback import lanczos_resize

    rng = np.random.default_rng(11)
    for h, w, oh, ow in ((54, 96, 18, 32), (37, 53, 12, 17),
                         (120, 200, 40, 66), (31, 47, 31, 20)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.LANCZOS))
        diff = np.abs(lanczos_resize(img, ow, oh).astype(int) - want)
        assert (diff <= 1).mean() >= 0.999 and diff.max() <= 2


def test_gif_round_trips_through_pil():
    """A frame of at most 256 colours decodes exactly (the palette then
    holds each colour; LZW codes up to 12 bits and table resets)."""
    from vkr_tpu_torch.core.readback import gif_bytes

    rng = np.random.default_rng(12)
    colours = rng.integers(0, 256, (200, 3), np.uint8)
    frames = colours[rng.integers(0, 200, (2, 150, 151))]
    gif = Image.open(io.BytesIO(gif_bytes(frames, 66)))
    assert gif.n_frames == 2 and gif.info["loop"] == 0
    for i in range(2):
        gif.seek(i)
        np.testing.assert_array_equal(np.asarray(gif.convert("RGB")),
                                      frames[i])


def test_render_preset_at_1080p_drops_no_bin_pair():
    """The render tool's colonnade (8 columns, 10,028 triangles) at
    1920x1080 needs 43,837 bin pairs at orbit frame 0; vkr_tpu's static
    capacity max(1.5 T, 4 n_tiles, 4096) = 14,994 drops 28,843 of them
    (holes: coverage 0.926 on the card). The port sizes the list to the
    pairs there are."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.raster import setup as S
    from vkr_tpu_torch.tools.render import load_preset, orbit_view

    w, h = 1920, 1080
    scene_np, preset = load_preset("colonnade", 16)
    scene = upload_scene(scene_np, "cpu")
    view = orbit_view(preset, 0, 0.01)
    cam = camera_frame(RenderConfig(width=w, height=h), view, view, 0, "cpu")
    ct = S.corner_transform_t(scene.corner_world_o, cam.mvp)
    n_src = ct.shape[1] // 3
    tri2, weights, valid = S.clip_near_corners_t(ct, n_src)
    st = S.triangle_setup_t(S.corners_from_weights_t(tri2, weights), valid,
                            w, h, cam.jitter)
    pair_tri, _, counts, overflow = S.bin_triangles_t(st.bbox, st.valid, w,
                                                      h, 8, 128, None)
    assert int(overflow) == 0 and int(counts.sum()) == 43837
    assert len(pair_tri) == 43837 and bool((pair_tri >= 0).all())
    static = max(int(1.5 * n_src), 4 * 15 * 135, 4096)
    *_, dropped = S.bin_triangles_t(st.bbox, st.valid, w, h, 8, 128, static)
    assert (static, int(dropped)) == (14994, 28843)


def test_pyramid_made_before_a_hot_reload_still_marches():
    """registry.reload() (the viewer's `r`) re-executes ssr.py, so a
    FlatPyramid made before it belongs to the class it replaced; the
    march reads it by its fields, not its class."""
    import collections

    from vkr_tpu_torch.passes import ssr, ssr_march

    levels = [torch.rand(8 >> i, 16 >> i) for i in range(3)]
    pyr = ssr.pack_pyramid(levels)
    stale = collections.namedtuple("FlatPyramid", ssr.FlatPyramid._fields)(
        *pyr)
    assert not isinstance(stale, ssr.FlatPyramid)
    assert ssr_march._pyramid(stale) is stale
    again = ssr_march._pyramid(levels)
    assert torch.equal(again.flat, pyr.flat) and again[1:] == pyr[1:]
