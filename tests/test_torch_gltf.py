"""glTF scenes from disk in vkr_tpu_torch against vkr_tpu: the loader and
its PNG decoder, the scene compiler (uniform and native_sizes=True), and
trilinear textures on a scene whose materials do not pair
(test_torch_gltf_frame.py renders the loaded scene).

The scene is written here (chip_smoke.write_gltf): the 8-column colonnade
at tessellation 8, textures at 32x32 (REPEAT, one sampled as
MIRRORED_REPEAT), 64x16 (the CLAMP pair of the columns and capitals) and
16x16 (the alpha-MASK leaves, no MR texture), one image by data: URI and
one by bufferView, positions and normals interleaved, a TRS parent node,
a line primitive and primitives without normals or uvs."""

import dataclasses
import io
import json
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from vkr_tpu_torch.core.readback import png_chunk, png_bytes

torch.set_num_threads(1)

TEX_SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def colonnade_gltf(directory, mat_mr=None):
    """Write the test scene; mat_mr overrides the materials' MR textures.
    Returns the .gltf path."""
    from vkr_tpu_torch.scene.gltf import Material
    from vkr_tpu_torch.scene.procedural import build_colonnade

    sc = build_colonnade(columns=8, tessellation=8, tex_size=TEX_SIZE)
    imgs = list(sc.images)
    for t in (3, 4, 7):  # 64 wide, 16 high
        imgs[t] = np.repeat(imgs[t][::2], 2, axis=1)
    imgs[5] = imgs[5][::2, ::2]
    sc.materials[5] = Material(albedo_tex=5, mr_tex=-1, clip_alpha=True,
                               alpha_cutoff=0.5)
    if mat_mr is not None:
        sc.materials = [dataclasses.replace(m, mr_tex=r)
                        for m, r in zip(sc.materials, mat_mr)]
    wraps = [0, 0, 0, 1, 1, 0, 0, 1]
    path = chip_smoke.write_gltf(str(directory), sc, imgs, wraps,
                                 data_uri=(5,), buffer_view=(6,))
    with open(path) as f:
        doc = json.load(f)
    doc["samplers"].append({"wrapS": 33648, "wrapT": 33648})
    doc["textures"][1]["sampler"] = len(doc["samplers"]) - 1
    # the last leaf under a TRS parent
    leaf = len(doc["nodes"]) - 1
    doc["nodes"].append({"translation": [0.5, 0.2, 0.1],
                         "rotation": [0.0, 0.2588190451, 0.0, 0.9659258263],
                         "scale": [1.1, 0.9, 1.0], "children": [leaf]})
    doc["scenes"][0]["nodes"] = [n for n in range(len(doc["nodes"]))
                                 if n != leaf]
    prims = doc["meshes"]
    prims[0]["primitives"].append(dict(prims[0]["primitives"][0], mode=1))
    capitals = [i for i, n in enumerate(doc["nodes"][:-1])
                if n.get("mesh") is not None
                and sc.meshes[n["mesh"]][0].material == 4]
    del prims[doc["nodes"][capitals[0]]["mesh"]]["primitives"][0][
        "attributes"]["NORMAL"]
    del prims[doc["nodes"][capitals[1]]["mesh"]]["primitives"][0][
        "attributes"]["TEXCOORD_0"]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    return colonnade_gltf(tmp_path_factory.mktemp("gltf"))


@pytest.fixture(scope="module")
def native_lib():
    """vkr_tpu's native asset pipeline, built as tests/test_native.py
    builds it: with it vkr_tpu resizes textures with its C++ bilinear,
    which the port follows (without it vkr_tpu takes PIL's)."""
    subprocess.run(["make", "-C", os.path.join(REPO, "vkr_tpu", "native")],
                   check=True, capture_output=True)
    from vkr_tpu import native

    native._lib = None
    assert native.available()


class TestLoader:
    def test_arrays_and_images_equal(self, gltf_path):
        from vkr_tpu.scene.gltf import load_gltf as j_load
        from vkr_tpu_torch.scene.gltf import load_gltf as t_load

        got, want = t_load(gltf_path), j_load(gltf_path)
        for f in ("positions", "normals", "uvs", "indices"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        assert len(got.images) == len(want.images) == 8
        for g, w in zip(got.images, want.images):
            assert g.dtype == w.dtype == np.uint8
            assert g.tobytes() == w.tobytes() and g.shape == w.shape
        assert [i.shape[:2] for i in got.images] == [
            (32, 32)] * 3 + [(16, 64)] * 2 + [(16, 16), (32, 32), (16, 64)]
        assert got.texture_image == want.texture_image
        assert got.texture_wrap == want.texture_wrap == [0, 0, 0, 1, 1, 0,
                                                         0, 1]
        assert [dataclasses.astuple(m) for m in got.materials] == [
            dataclasses.astuple(m) for m in want.materials]
        assert [[dataclasses.astuple(p) for p in m] for m in got.meshes] == [
            [dataclasses.astuple(p) for p in m] for m in want.meshes]
        assert len(got.draw_calls) == len(want.draw_calls)
        for g, w in zip(got.draw_calls, want.draw_calls):
            assert g.mesh == w.mesh
            np.testing.assert_array_equal(g.transform, w.transform)
        assert got.nodes == want.nodes
        # the defaults of missing attributes were taken
        assert (got.normals == [0, 0, 1]).all(axis=1).any()

    def test_strided_accessor_matches_loop(self, gltf_path):
        """The vectorised interleaved read equals vkr_tpu's per-element
        loop (its _read_accessor) on every accessor of the file."""
        from vkr_tpu.scene import gltf as jg
        from vkr_tpu_torch.scene import gltf as tg

        with open(gltf_path) as f:
            g = json.load(f)
        buffers = tg._load_buffers(g, os.path.dirname(gltf_path))
        strided = 0
        for i, acc in enumerate(g["accessors"]):
            strided += "byteStride" in g["bufferViews"][acc["bufferView"]]
            np.testing.assert_array_equal(tg._read_accessor(g, buffers, i),
                                          jg._read_accessor(g, buffers, i))
        assert strided > 10


def _encode(px, ctype, filters, extra=b""):
    return png_bytes(px, ctype, filters, extra)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_matches_pil(ctype, filters):
    """The port's decoder against PIL's decode + convert("RGBA") (what
    vkr_tpu calls), per colour type and row filter; types 0, 2 and 3 with
    a tRNS chunk."""
    from PIL import Image

    from vkr_tpu_torch.scene.gltf import decode_png

    chunk = png_chunk
    rng = np.random.default_rng(ctype * 10 + len(filters))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 256, (19, 23, channels), np.uint8)
    extra = b""
    if ctype == 3:
        px = rng.integers(0, 9, (19, 23, 1), np.uint8)
        extra = (chunk(b"PLTE", rng.integers(0, 256, 27, np.uint8).tobytes())
                 + chunk(b"tRNS", bytes([0, 90, 180])))
    elif ctype == 0:
        extra = chunk(b"tRNS", struct.pack(">H", int(px[2, 3, 0])))
    elif ctype == 2:
        extra = chunk(b"tRNS", struct.pack(">HHH", *map(int, px[4, 5])))
    data = _encode(px, ctype, filters, extra)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = decode_png(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if ctype in (0, 2, 3):
        assert (got[..., 3] == 0).any()


@pytest.mark.parametrize("name", [
    "item18_12bit.jpg", "item18_hierarchical.jpg", "item18_dnl.jpg"],
    ids=["12-bit-sof1", "hierarchical", "dnl-height"])
def test_unported_images_raise(name):
    """The JPEG forms PIL refuses (12-bit samples, a hierarchical file, a
    height given only in a DNL marker; committed files of
    tests/torch_images/make_images.py) are refused by the port too, with
    NotImplementedError naming their ROADMAP item."""
    from PIL import Image

    from vkr_tpu_torch.scene.gltf import _decode_image

    with open(os.path.join(os.path.dirname(__file__), "torch_images",
                           name), "rb") as f:
        data = f.read()
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _decode_image(data)


@pytest.mark.parametrize("native_sizes", [False, True],
                         ids=["uniform", "native"])
def test_compile_scene_equals_vkr_tpu(gltf_path, native_lib, native_sizes):
    """Every CompiledScene field equal, the uniform resize (64x16 and 16x16
    -> 32x32) and the native integer-factor downscale (64x16 -> 32x8)
    included. In native mode the port builds no uniform pyramid, which
    vkr_tpu builds and never reads there: tex_mips is None."""
    from vkr_tpu.scene.scene import load_scene as j_load
    from vkr_tpu_torch.scene.scene import load_scene as t_load

    got = t_load(gltf_path, tex_size=TEX_SIZE, native_sizes=native_sizes)
    want = j_load(gltf_path, tex_size=TEX_SIZE, native_sizes=native_sizes)
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "tex_mips" and native_sizes:
            assert g is None and w is not None
        elif f in ("tex_mips", "tex_images"):
            assert (g is None) == (w is None) == (
                f == "tex_images" and not native_sizes), f
            if g is not None:
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    if native_sizes:
        assert [im.shape[:2] for im in got.tex_images] == [
            (32, 32)] * 3 + [(8, 32)] * 2 + [(16, 16), (32, 32), (8, 32)]


def test_resize_follows_the_native_library(native_lib):
    """_resize_rgba equals vkr_tpu's C++ bilinear (asset_pipeline.cpp:52-77)
    on random images, down and up, non-square. vkr_tpu's fallback without
    the library, PIL's antialiased BILINEAR, is another function."""
    from PIL import Image

    from vkr_tpu import native
    from vkr_tpu_torch.scene.scene import _resize_rgba

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 48, 4), np.uint8)
    pil = np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR))
    diff = np.abs(pil.astype(int) - _resize_rgba(img, 32).astype(int))
    print(f"PIL's BILINEAR against the C++ on 64x48 -> 32x32: max "
          f"{diff.max()}, {(diff > 0).mean():.4f} of the bytes differ")
    assert (diff > 0).mean() > 0.5
    for h, w, size in ((64, 48, 32), (16, 64, 32), (7, 13, 32),
                       (300, 17, 64), (64, 64, 24)):
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        np.testing.assert_array_equal(_resize_rgba(img, size),
                                      native.resize_rgba8(img, size, size))


def _cameras(i, width, height):
    from vkr_tpu.config import RenderConfig
    from vkr_tpu.frame import camera_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    cfg = RenderConfig(width=width, height=height, trilinear_textures=True)
    return cfg, camera_frame(cfg, bench_orbit_view(i),
                             bench_orbit_view(max(i - 1, 0)), i)


def test_unpaired_scene_ignores_trilinear(tmp_path, native_lib):
    """When a material's albedo and MR differ in dims, neither side packs
    pairs, and each samples bilinearly at the rounded mip: the trilinear
    G-buffer equals the bilinear one bit for bit, on both sides (vkr_tpu
    through its oracle path)."""
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.scene import load_scene as j_load
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.scene.scene import load_scene

    # column material 3: a 32x8 albedo with the 32x32 MR texture 6
    path = colonnade_gltf(tmp_path, mat_mr=[6, 6, 6, 6, 7, -1])
    cfg, cam = _cameras(1, 64, 32)
    kw = dict(width=64, height=32, quantize=True, mask_peel_layers=2)
    jscene = j_upload(j_load(path, tex_size=TEX_SIZE, native_sizes=True))
    scene = upload_scene(load_scene(path, tex_size=TEX_SIZE,
                                    native_sizes=True), "cpu")
    assert not scene.tex.paired and jscene.tex.pair_quad is None
    args = [torch.from_numpy(np.array(a)) for a in
            (cam.mvp, cam.prev_mvp, cam.jitter)]
    t = [render_gbuffer(scene, *args, trilinear=tri, **kw)
         for tri in (True, False)]
    j = [j_render(jscene, cam.mvp, cam.prev_mvp, cam.jitter,
                  use_pallas=False, trilinear=tri, **kw)
         for tri in (True, False)]
    for name in ("albedo", "material"):
        torch.testing.assert_close(getattr(t[0], name), getattr(t[1], name),
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(getattr(j[0], name)),
                                      np.asarray(getattr(j[1], name)))
    assert float((t[0].depth < 1.0).float().mean()) > 0.5
