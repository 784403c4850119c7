"""The Sponza stand-in, frozen: Sponza/glTF/Sponza.gltf in Sponza's layout
(25 materials, 69 textures over 69 images, one REPEAT sampler, no
geometry), written from a seed. A copy of the port's
chip_smoke.write_sponza_standin and of the PNG writer it calls
(vkr_tpu_torch/core/readback.py:png_bytes, png_chunk) as they stood at
commit 19870451, so that a later change to the program cannot move the
inputs. The JPEGs it takes are copies of tests/torch_images' (the forms
PIL decodes), under benchmark/data/jpegs.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

JPEG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "jpegs")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG row filters, taken in turn by row
PNG_FILTERS = (0, 1, 2, 3, 4)

SPONZA_MATERIALS = 25
SPONZA_IMAGES = 69
# PNG sizes of the stand-in, (height, width), taken in turn: resizes to
# 1024² go down, up, across and stay
SPONZA_PNG_SIZES = ((512, 512), (1024, 1024), (1024, 2048), (512, 256))
# PNG forms, taken in turn: (colour type, label)
SPONZA_PNG_FORMS = ((2, "RGB"), (0, "grey"), (3, "palette"),
                    (3, "palette with tRNS"), (4, "grey+alpha"))
# the MASK materials and their alphaCutoff (None: absent, 0.5); the first
# one is the colonnade foliage's
SPONZA_MASKS = {2: 0.3, 9: None, 16: 0.7}
SPONZA_NO_MR = (20, 21, 22, 23, 24)  # no metallicRoughnessTexture
SPONZA_NO_ALBEDO = (24,)          # no baseColorTexture


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def png_bytes(px, colour_type: int = 6, filters=(0,), extra: bytes = b"",
              level: int = 6) -> bytes:
    """An 8-bit, non-interlaced PNG of px (H, W, channels) u8: row y is
    filtered with filters[y % len(filters)] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth). extra: chunks to put before the image data."""
    px = np.asarray(px, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, 1:] = x[:-1, :-1]
    pa = np.abs(up - up_left)
    pb = np.abs(left - up_left)
    pc = np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    kinds = np.asarray([filters[y % len(filters)] for y in range(h)],
                       np.uint8)
    pred = np.choose(kinds[:, None, None],
                     [np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    rows = np.concatenate(
        [kinds[:, None], ((x - pred) & 255).astype(np.uint8).reshape(h, -1)],
        axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return (PNG_SIGNATURE + png_chunk(b"IHDR", header) + extra
            + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + png_chunk(b"IEND", b""))


def standin_jpegs():
    """The committed JPEGs the stand-in takes, (name, form), in name
    order."""
    with open(os.path.join(JPEG_DIR, "forms.json")) as f:
        return [tuple(j) for j in json.load(f)["jpegs"]]


def _standin_pixels(rng, h, w, channels):
    """Seeded waves: (h, w, channels) u8."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((h, w, channels), np.uint8)
    for c in range(channels):
        fx, fy = rng.uniform(1.0, 9.0, 2).astype(np.float32)
        phase = np.float32(rng.uniform(0.0, 6.3))
        out[..., c] = (127.5 + 127.0 * np.sin(
            np.float32(6.2832) * (fx * x + fy * y) + phase)).astype(np.uint8)
    return out


def write_sponza_standin(root, seed=0, size_scale=1.0):
    """Write root/Sponza/glTF/Sponza.gltf in Sponza's layout: 25
    materials (albedo and metallic-roughness textures, normalTexture,
    MASK with and without alphaCutoff, some with no metallic-roughness or
    no base-colour texture), 69 textures whose sources are a seeded
    derangement of the 69 images, one REPEAT sampler, no geometry. The
    images are the committed JPEGs and seeded PNGs in turn RGB, grey,
    palette, palette with tRNS and grey+alpha at SPONZA_PNG_SIZES times
    size_scale; the MASK materials' base colours are RGBA PNGs with
    alphas of 0, 255 and between. seed: any whole number >= 0. Returns the
    .gltf path."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "Sponza", "glTF")
    os.makedirs(base, exist_ok=True)
    n = SPONZA_IMAGES
    # textures: albedo of every material but SPONZA_NO_ALBEDO, then MR of
    # every material but SPONZA_NO_MR, then a normal map of each
    albedo, mr, normal, t = {}, {}, {}, 0
    for table, skip in ((albedo, SPONZA_NO_ALBEDO), (mr, SPONZA_NO_MR),
                        (normal, ())):
        for m in range(SPONZA_MATERIALS):
            if m not in skip:
                table[m] = t
                t += 1
    if t != n:
        raise ValueError(f"the stand-in's layout makes {t} textures, not {n}")
    jpegs = standin_jpegs()
    # image kinds: the MASK albedo images are RGBA PNGs, the JPEGs spread
    # over the rest
    rgba_images = list(range(len(SPONZA_MASKS)))
    rest = rng.permutation(np.arange(len(SPONZA_MASKS), n)).tolist()
    jpeg_images = dict(zip(sorted(rest[:len(jpegs)]), jpegs))
    # texture -> image: the MASK albedos onto the RGBA images, the others
    # a derangement of the remaining images
    source = {albedo[m]: rgba_images[i] for i, m in enumerate(SPONZA_MASKS)}
    free_t = [t for t in range(n) if t not in source]
    free_i = [i for i in range(n) if i not in rgba_images]
    while True:
        perm = rng.permutation(free_i)
        if all(int(i) != t for t, i in zip(free_t, perm)):
            break
    source.update({t: int(i) for t, i in zip(free_t, perm)})

    images = []
    png_i = 0
    for i in range(n):
        if i in jpeg_images:
            name, _ = jpeg_images[i]
            with open(os.path.join(JPEG_DIR, name), "rb") as f:
                data = f.read()
            uri = f"standin_{i:02d}.jpg"
        else:
            h, w = SPONZA_PNG_SIZES[png_i % len(SPONZA_PNG_SIZES)]
            h = max(1, round(h * size_scale))
            w = max(1, round(w * size_scale))
            if i in rgba_images:
                ctype, label = 6, "RGBA, partial alpha"
                px = _standin_pixels(rng, h, w, 4)
                a = px[..., 3].astype(np.int16)
                px[..., 3] = np.clip(3 * (a - 128) + 128, 0, 255)
            else:
                ctype, label = SPONZA_PNG_FORMS[
                    png_i % len(SPONZA_PNG_FORMS)]
                px = _standin_pixels(rng, h, w, {2: 3, 0: 1, 3: 1,
                                                 4: 2}[ctype])
            extra = b""
            if ctype == 3:
                px = px // 16
                extra = png_chunk(b"PLTE", rng.integers(
                    0, 256, 48, np.uint8).tobytes())
                if "tRNS" in label:
                    extra += png_chunk(b"tRNS", rng.integers(
                        0, 256, 16, np.uint8).tobytes())
            data = png_bytes(px, colour_type=ctype, filters=PNG_FILTERS,
                             extra=extra, level=1)
            uri = f"standin_{i:02d}.png"
            png_i += 1
        with open(os.path.join(base, uri), "wb") as f:
            f.write(data)
        images.append({"uri": uri})

    materials = []
    for m in range(SPONZA_MATERIALS):
        pbr = {"metallicFactor": 0.0}
        if m in albedo:
            pbr["baseColorTexture"] = {"index": albedo[m]}
        if m in mr:
            pbr["metallicRoughnessTexture"] = {"index": mr[m]}
        mat = {"name": f"standin_material_{m:02d}",
               "pbrMetallicRoughness": pbr,
               "normalTexture": {"index": normal[m]}}
        if m in SPONZA_MASKS:
            mat["alphaMode"] = "MASK"
            if SPONZA_MASKS[m] is not None:
                mat["alphaCutoff"] = SPONZA_MASKS[m]
        materials.append(mat)
    doc = {
        "asset": {"version": "2.0", "generator": "sponza stand-in"},
        "scene": 0, "scenes": [{"nodes": []}], "nodes": [], "meshes": [],
        "materials": materials,
        "textures": [{"sampler": 0, "source": source[t]} for t in range(n)],
        "samplers": [{"magFilter": 9729, "minFilter": 9987,
                      "wrapS": 10497, "wrapT": 10497}],
        "images": images,
    }
    path = os.path.join(base, "Sponza.gltf")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path
