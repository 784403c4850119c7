"""bench.py's Sponza-textured colonnade against vkr_tpu on the CPU:
vkr_tpu_torch/scene/resample.py (Pillow's BILINEAR resize, byte for byte
against Pillow), scene/procedural.py's sponza_texture_set and
sponza_colonnade_scene against vkr_tpu's, and the foliage= and seed=
arguments of build_colonnade and colonnade_scene.

The reference's Sponza textures are not in this repository: both
packages read chip_smoke.write_sponza_standin's stand-in in Sponza's
layout (25 materials, 69 images: the committed JPEGs and seeded PNGs of
every form, edges of 8-64 px here), the port through $VKR_ASSETS and
vkr_tpu through its SPONZA_GLTF, patched for the test. The port's image
decodes are memoised across the file (its decoders are held to PIL in
tests/test_torch_images.py), so the committed 1024² JPEGs decode once."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke

torch.set_num_threads(1)

SCALE = 1 / 32


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("assets"))
    path, info = chip_smoke.write_sponza_standin(root, seed=0,
                                                 size_scale=SCALE)
    return root, path, info


@pytest.fixture(scope="module")
def memo_decode():
    from vkr_tpu_torch.scene import gltf as gltf_mod

    decode = gltf_mod._decode_image
    cache = {}

    def memo(data):
        key = bytes(data)
        if key not in cache:
            cache[key] = decode(data)
        return cache[key].copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gltf_mod, "_decode_image", memo)
        yield


@pytest.fixture
def sponza(standin, memo_decode, monkeypatch):
    """Both packages pointed at the stand-in."""
    import vkr_tpu.scene.procedural as j_proc

    root, path, _ = standin
    monkeypatch.setenv("VKR_ASSETS", root)
    monkeypatch.setattr(j_proc, "SPONZA_GLTF", path)
    return path


# ----------------------------------------------------------- the resize

def _resize_cases(kind, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(2, 71, 2))
        if kind == "down":
            oh, ow = (int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1)))
        elif kind == "up":
            oh, ow = (int(rng.integers(h, 2 * h + 3)),
                      int(rng.integers(w, 2 * w + 3)))
        elif kind == "non-square":
            oh, ow = int(rng.integers(1, 90)), int(rng.integers(1, 90))
            if oh == ow:
                ow += 1
        else:  # one axis only: the other pass does not run
            oh, ow = (h, int(rng.integers(1, 90))) if rng.random() < 0.5 \
                else (int(rng.integers(1, 90)), w)
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        alpha = rng.random((h, w))
        img[..., 3][alpha < 0.2] = 0
        img[..., 3][alpha > 0.8] = 255
        yield img, ow, oh


@pytest.mark.parametrize("kind", ["down", "up", "non-square", "one-axis"])
def test_pil_bilinear_resize_equals_pillow(kind):
    """60 seeded RGBA cases per kind (240 in all; random alpha with
    alphas of 0 and 255 and odd sizes): byte for byte Pillow's
    Image.resize(..., Image.BILINEAR)."""
    from vkr_tpu_torch.scene.resample import pil_bilinear_resize

    seed = ["down", "up", "non-square", "one-axis"].index(kind)
    for img, ow, oh in _resize_cases(kind, 60, seed):
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        got = pil_bilinear_resize(img, ow, oh)
        assert got.dtype == np.uint8 and got.shape == (oh, ow, 4)
        np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} -> "
                                      f"{oh}x{ow}")


def test_pil_bilinear_resize_texture_sizes():
    """The stand-in's resizes to 32² and 1024² (down, up, across), and an
    image at the target size comes back as it is, as PIL is not asked."""
    from vkr_tpu_torch.scene.resample import pil_bilinear_resize

    rng = np.random.default_rng(7)
    for h, w, size in ((64, 32, 32), (16, 16, 32), (8, 16, 32),
                       (512, 256, 1024), (1024, 2048, 1024)):
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        want = np.asarray(Image.fromarray(img).resize((size, size),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(pil_bilinear_resize(img, size, size),
                                      want)
    img = rng.integers(0, 256, (32, 32, 4), np.uint8)
    assert pil_bilinear_resize(img, 32, 32) is img


# ------------------------------------------------- foliage= and seed=

def _assert_scenes_equal(got, want):
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "tex_mips":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "tex_images":
            assert g is None and w is None
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("foliage,seed", [(False, 3), (True, 3),
                                          (True, 0)])
def test_colonnade_foliage_and_seed_equal_vkr_tpu(foliage, seed):
    """build_colonnade's and colonnade_scene's foliage= and seed= as
    vkr_tpu's: every CompiledScene field equal; the defaults (foliage on,
    seed 0) give what the positional call gives."""
    from vkr_tpu.scene.procedural import colonnade_scene as j_scene
    from vkr_tpu_torch.scene.procedural import (build_colonnade,
                                                colonnade_scene)

    kw = dict(columns=4, tessellation=8, tex_size=32)
    got = colonnade_scene(**kw, foliage=foliage, seed=seed)
    _assert_scenes_equal(got, j_scene(**kw, foliage=foliage, seed=seed))
    masked = int((got.mat_clip_alpha[got.tri_material] > 0).sum())
    assert masked == (2 * 2 * kw["columns"] if foliage else 0)
    if (foliage, seed) == (True, 0):
        _assert_scenes_equal(colonnade_scene(4, 8, 32), got)
        a, b = build_colonnade(4, 8, 32), build_colonnade(4, 8, 32, True, 1)
        assert not np.array_equal(a.images[1], b.images[1])


# ------------------------------------------------------- the Sponza set

def test_standin_has_sponzas_layout(standin):
    """25 materials, 69 textures and images; every texture's source is
    another image; MASK materials with and without alphaCutoff, one
    material without a base colour, five without metallic-roughness;
    PNG sizes going down, up and across to 32², RGBA with partial alpha
    under the MASK materials; the committed JPEGs."""
    import json

    _, path, info = standin
    with open(path) as f:
        doc = json.load(f)
    assert len(doc["materials"]) == 25 and len(doc["images"]) == 69
    assert len(doc["textures"]) == 69 and not doc["meshes"]
    assert all(t["source"] != i for i, t in enumerate(doc["textures"]))
    assert sorted(t["source"] for t in doc["textures"]) == list(range(69))
    mats = doc["materials"]
    masks = [m for m in mats if m.get("alphaMode") == "MASK"]
    assert {m.get("alphaCutoff", 0.5) for m in masks} == {0.3, 0.5, 0.7}
    assert any("alphaCutoff" not in m for m in masks)
    pbr = [m["pbrMetallicRoughness"] for m in mats]
    assert sum("baseColorTexture" not in p for p in pbr) == 1
    assert sum("metallicRoughnessTexture" not in p for p in pbr) == 5
    kinds = info["kinds"]
    for form in ("RGBA, partial alpha", "grey", "palette", "tRNS", "RGB",
                 "16x16", "32x32", "64x32", "8x16", "item18_sof10_256",
                 "item18_sof3_256", "colonnade_tex5", "item18_ycck"):
        assert any(form in k for k in kinds.values()), form
    assert info["jpegs"] == len(chip_smoke.standin_jpegs()) == 26
    base = os.path.dirname(path)
    for m in masks:
        src = doc["textures"][m["pbrMetallicRoughness"]["baseColorTexture"][
            "index"]]["source"]
        alpha = np.asarray(Image.open(os.path.join(
            base, doc["images"][src]["uri"])).convert("RGBA"))[..., 3]
        assert (alpha == 0).any() and (alpha == 255).any()
        assert ((alpha > 0) & (alpha < 255)).any()


@pytest.mark.parametrize("tex_size", [16, 32])
def test_sponza_texture_set_equals_vkr_tpu(sponza, tex_size):
    """Every image (decoded and resized), texture index, material and
    wrap equal to vkr_tpu's (PIL's convert("RGBA") and resize)."""
    from vkr_tpu.scene.procedural import sponza_texture_set as j_set
    from vkr_tpu_torch.scene.procedural import sponza_texture_set

    mats, images, tex_image, wraps = sponza_texture_set(tex_size)
    jmats, jimages, jtex_image, jwraps = j_set(tex_size)
    assert len(images) == len(jimages) == 69
    for i, (a, b) in enumerate(zip(images, jimages)):
        assert a.shape == (tex_size, tex_size, 4), i
        np.testing.assert_array_equal(a, b, err_msg=f"image {i}")
    assert tex_image == jtex_image and wraps == jwraps
    assert [vars(m) for m in mats] == [vars(m) for m in jmats]
    assert sorted({m.alpha_cutoff for m in mats if m.clip_alpha}) == [
        0.3, 0.5, 0.7]


def test_sponza_colonnade_scene_equals_vkr_tpu(sponza):
    """sponza_colonnade_scene(columns=4, tessellation=8, tex_size=32):
    every CompiledScene field equal to vkr_tpu's, the foliage on the
    first MASK material (alphaCutoff 0.3)."""
    from vkr_tpu.scene.procedural import sponza_colonnade_scene as j_scene
    from vkr_tpu_torch.scene.procedural import sponza_colonnade_scene

    kw = dict(columns=4, tessellation=8, tex_size=32)
    got = sponza_colonnade_scene(**kw)
    _assert_scenes_equal(got, j_scene(**kw))
    used = sorted(set(got.tri_material.tolist()))
    assert len(used) == 6 and len(got.mat_albedo_tex) == 25
    foliage = [m for m in used if got.mat_clip_alpha[m]]
    assert len(foliage) == 1
    assert float(got.mat_alpha_cutoff[foliage[0]]) == pytest.approx(0.3)
    textures = {int(t) for m in used for t in (got.mat_albedo_tex[m],
                                               got.mat_mr_tex[m]) if t >= 0}
    assert len(textures) <= 12
    assert got.tex_mips[0].shape == (69, 32, 32, 4)


def test_sponza_reads_vkr_assets(tmp_path, monkeypatch):
    """Unset, VKR_ASSETS is named; set to a directory without Sponza, the
    missing path is. The render tool's asset_path is the scene layer's."""
    import re

    from vkr_tpu_torch.scene import assets
    from vkr_tpu_torch.scene.procedural import (SPONZA_ASSET,
                                                sponza_colonnade_scene)
    from vkr_tpu_torch.tools import render

    assert render.asset_path is assets.asset_path
    assert render.ASSETS_ENV == assets.ASSETS_ENV == "VKR_ASSETS"
    monkeypatch.delenv("VKR_ASSETS", raising=False)
    with pytest.raises(FileNotFoundError, match="VKR_ASSETS"):
        sponza_colonnade_scene(columns=2, tessellation=4, tex_size=8)
    monkeypatch.setenv("VKR_ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / SPONZA_ASSET))):
        sponza_colonnade_scene(columns=2, tessellation=4, tex_size=8)
