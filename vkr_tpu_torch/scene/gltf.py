"""From-scratch glTF 2.0 loader -> numpy SoA, and the PNG decoder it needs.

The counterpart of vkr_tpu.scene.gltf, which mirrors the reference's
tiny_gltf-based loader (scene/scene.cpp:330-360): meshes merged into one
vertex/index pool, materials with albedo/metallic-roughness texture
indices + alpha-MASK flag, node hierarchy flattened to per-draw-call
transforms. Supports the subset the reference consumes (POSITION/NORMAL/
TEXCOORD_0, scalar indices, TRS or matrix nodes, pbrMetallicRoughness) and
tolerates missing pieces the way the reference does.

vkr_tpu decodes images with PIL; the port decodes them itself, with zlib
and numpy, to the RGBA bytes PIL's convert("RGBA") gives: PNG here (every
colour type and bit depth, tRNS, Adam7 interlacing, all five row
filters), Huffman-coded JPEG in scene/jpeg.py.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
import zlib
from typing import List

import numpy as np
from numpy.lib.stride_tricks import as_strided

from vkr_tpu_torch.core.graph import count, span
from vkr_tpu_torch.scene.jpeg import decode_jpeg

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}

WRAP_REPEAT = 0
WRAP_CLAMP = 1
# glTF wrapS: REPEAT, CLAMP_TO_EDGE, MIRRORED_REPEAT (sampled as REPEAT)
_GL_WRAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_REPEAT}


@dataclasses.dataclass
class Primitive:
    """Mirrors reference scene.hpp:21-26."""

    vertex_offset: int
    index_offset: int
    index_count: int
    material: int


@dataclasses.dataclass
class Material:
    """Mirrors reference scene/scene.cpp:171-181."""

    albedo_tex: int = -1      # texture index or -1
    mr_tex: int = -1
    clip_alpha: bool = False  # alphaMode == MASK
    alpha_cutoff: float = 0.5


@dataclasses.dataclass
class DrawCall:
    mesh: int
    transform: np.ndarray  # (4, 4) world matrix


@dataclasses.dataclass
class GltfScene:
    positions: np.ndarray   # (V, 3) f32
    normals: np.ndarray     # (V, 3) f32
    uvs: np.ndarray         # (V, 2) f32
    indices: np.ndarray     # (I,) u32 (relative to prim vertex_offset)
    meshes: List[List[Primitive]]
    materials: List[Material]
    images: List[np.ndarray]       # decoded RGBA8 (H, W, 4) u8
    texture_image: List[int]       # texture -> image index
    texture_wrap: List[int]        # texture -> WRAP_*
    draw_calls: List[DrawCall]
    nodes: List[dict]              # raw node dicts (for animation later)


# ----------------------------------------------------------------- PNG

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """(type, payload) of each chunk after the signature."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _skewed(h: int, w: int, c: int):
    """A zero (H + 1, H + W + 1, C) int16 wavefront array s and its
    (H, W, C) view a with a[y, x] at s[y + 1, x + y + 2]: the anti-diagonal
    x + y = k of a is column k + 2 of s, and row 0 and the column before
    each row stay zero (the filters' missing neighbours)."""
    s = np.zeros((h + 1, h + w + 1, c), np.int16)
    r, col, ch = s.strides
    return s, as_strided(s[1:, 2:], shape=(h, w, c),
                         strides=(r + col, col, ch))


def _unfilter(ftype: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters. ftype (H,) u8; raw (H, N, bpp) u8 filtered
    bytes: a filter's left neighbour is the byte bpp = max(1, bits per
    pixel / 8) before, so sub-byte pixels filter byte by byte.

    Sub, Average and Paeth run left to right along a row and every filter
    reads the row above, so the decoded pixel (y, x) needs (y, x - 1),
    (y - 1, x) and (y - 1, x - 1). Rows of None/Sub/Up alone decode row by
    row (Sub is a cumulative sum); otherwise the pixels are decoded one
    anti-diagonal at a time, each diagonal a vectorised step."""
    h, w, _ = raw.shape
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not 0-4")
    out = np.zeros_like(raw)
    if not np.isin(ftype, (3, 4)).any():
        prior = np.zeros_like(raw[0])
        for y in range(h):
            f = ftype[y]
            if f == 1:
                out[y] = np.cumsum(raw[y], axis=0, dtype=np.uint8)
            elif f == 2:
                out[y] = raw[y] + prior
            else:
                out[y] = raw[y]
            prior = out[y]
        return out

    rs, rview = _skewed(*raw.shape)
    rview[...] = raw
    s, sview = _skewed(*raw.shape)
    kinds = [(ftype == f)[:, None] for f in range(1, 5)]
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h - 1, k) + 1
        col = k + 2
        a = s[lo + 1:hi + 1, col - 1]   # left
        b = s[lo:hi, col - 1]           # up
        c = s[lo:hi, col - 2]           # up-left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([m[lo:hi] for m in kinds],
                         [a, b, (a + b) >> 1, paeth], 0)
        s[lo + 1:hi + 1, col] = (rs[lo + 1:hi + 1, col] + pred) & 255
    return sview.astype(np.uint8)


def _png_image(raw, pos, w, h, depth, channels):
    """Unfilter and unpack the h rows of one (sub-)image at raw[pos:].
    Returns ((h, w, channels) int32 samples, the position after it)."""
    bits = depth * channels
    bpp = max(1, bits // 8)
    stride = -(-w * bits // 8)
    end = pos + h * (1 + stride)
    if end > len(raw):
        raise ValueError("PNG image data ends early")
    rows = raw[pos:end].reshape(h, 1 + stride)
    data = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, stride // bpp, bpp)
                     ).reshape(h, stride).astype(np.int32)
    if depth == 16:
        pairs = data.reshape(h, w * channels, 2)
        samples = (pairs[..., 0] << 8) | pairs[..., 1]
    elif depth == 8:
        samples = data
    else:
        per = 8 // depth
        shifts = depth * np.arange(per - 1, -1, -1)
        samples = ((data[..., None] >> shifts) & ((1 << depth) - 1)
                   ).reshape(h, -1)[:, :w]
    return samples.reshape(h, w, channels), end


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8, as PIL's Image.convert("RGBA") gives.

    PIL's modes decide the 8-bit values: grey at 1 bit is 0 or 255, at 2
    and 4 bits scaled by 85 and 17; 16-bit grey (mode I;16) clips to 255;
    other 16-bit samples keep their high byte. A tRNS key marks the
    pixels whose 8-bit grey or RGB values equal its low bytes, except at
    1-bit grey, where any nonzero key marks the white pixels."""
    if data[:len(PNG_SIGNATURE)] != PNG_SIGNATURE:
        raise ValueError("not a PNG stream")
    header = plte = trns = None
    idat = []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth}")
    channels = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        samples = np.zeros((h, w, channels), np.int32)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:  # an empty pass has no filter bytes
                samples[y0::dy, x0::dx], pos = _png_image(
                    raw, pos, pw, ph, depth, channels)
    else:
        samples, _ = _png_image(raw, 0, w, h, depth, channels)

    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        if plte is not None:
            colours = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
            pal[:len(colours), :3] = colours
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[samples[..., 0]]
    grey = ctype in (0, 4)
    if depth == 16:
        px = np.minimum(samples, 255) if ctype == 0 else samples >> 8
    elif depth < 8:
        px = samples * (255 // ((1 << depth) - 1))
    else:
        px = samples
    px = px.astype(np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    out[..., :3] = px[..., :1] if grey else px[..., :3]
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
    elif trns is not None:
        # the transparent colour: one grey or RGB sample of 16 bits each
        key = np.frombuffer(trns, ">u2")[:1 if grey else 3]
        key = (np.where(key != 0, 255, 0) if depth == 1
               else key & 0xFF).astype(np.uint8)
        match = (px == key).all(axis=-1)
        out[..., 3] = np.where(match, 0, 255)
    return out


def _decode_image(data: bytes) -> np.ndarray:
    """An image's bytes -> (H, W, 4) u8, by its signature. A start-up span
    "decode"; counters decode.images and decode.bytes (the bytes read)."""
    with span("decode", startup=True):
        if data[:2] == b"\xff\xd8":
            image = decode_jpeg(data)
        elif data[:len(PNG_SIGNATURE)] == PNG_SIGNATURE:
            image = decode_png(data)
        else:
            raise ValueError(
                f"image is neither PNG nor JPEG (starts {data[:8]!r})")
    count("decode.images", startup=True)
    count("decode.bytes", len(data), startup=True)
    return image


# ---------------------------------------------------------------- glTF

def _load_buffers(g: dict, base_dir: str) -> List[bytes]:
    out = []
    for buf in g.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(g: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = g["accessors"][idx]
    view = g["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    elem = dtype.itemsize * ncomp
    stride = view.get("byteStride", 0) or elem
    raw = buffers[view["buffer"]]
    if stride == elem:
        arr = np.frombuffer(raw, dtype=dtype, count=count * ncomp,
                            offset=offset).reshape(count, ncomp)
        return arr.copy()
    # interleaved: one strided view of the elements' bytes
    end = offset + (count - 1) * stride + elem if count else offset
    if end > len(raw):
        raise ValueError(f"accessor {idx} reads past its buffer")
    buf = np.frombuffer(raw, np.uint8)
    elems = as_strided(buf[offset:], shape=(count, elem), strides=(stride, 1))
    return np.ascontiguousarray(elems).view(dtype).reshape(count, ncomp)


def _node_local(node: dict) -> np.ndarray:
    """TRS or matrix node transform (reference tinygltf_load_nodes,
    scene.cpp:305-328)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(np.asarray(list(node["scale"]) + [1.0], np.float32))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _image_bytes(g: dict, img: dict, buffers, base_dir: str) -> bytes:
    """An image's encoded bytes: by file URI, data: URI or bufferView."""
    if "uri" in img and not img["uri"].startswith("data:"):
        with open(os.path.join(base_dir, img["uri"]), "rb") as f:
            return f.read()
    if "uri" in img:
        return base64.b64decode(img["uri"].split(",", 1)[1])
    view = g["bufferViews"][img["bufferView"]]
    off = view.get("byteOffset", 0)
    return buffers[view["buffer"]][off:off + view["byteLength"]]


def load_gltf(path: str, load_images: bool = True) -> GltfScene:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        g = json.load(f)
    buffers = _load_buffers(g, base_dir)

    positions: List[np.ndarray] = []
    normals: List[np.ndarray] = []
    uvs: List[np.ndarray] = []
    indices: List[np.ndarray] = []
    meshes: List[List[Primitive]] = []
    v_off = 0
    i_off = 0

    for mesh in g.get("meshes", []):
        prims = []
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only, like the reference
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(g, buffers, attrs["POSITION"]).astype(
                np.float32)
            n = pos.shape[0]
            if "NORMAL" in attrs:
                nrm = _read_accessor(g, buffers, attrs["NORMAL"]).astype(
                    np.float32)
            else:
                nrm = np.zeros((n, 3), np.float32)
                nrm[:, 2] = 1.0
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(g, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32)
            else:
                uv = np.zeros((n, 2), np.float32)
            if "indices" in prim:
                idx = _read_accessor(g, buffers, prim["indices"])
                idx = idx.reshape(-1).astype(np.uint32)
            else:
                idx = np.arange(n, dtype=np.uint32)
            positions.append(pos)
            normals.append(nrm)
            uvs.append(uv)
            indices.append(idx)
            prims.append(Primitive(vertex_offset=v_off, index_offset=i_off,
                                   index_count=len(idx),
                                   material=prim.get("material", -1)))
            v_off += n
            i_off += len(idx)
        meshes.append(prims)

    materials = []
    for mat in g.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        materials.append(Material(
            albedo_tex=pbr.get("baseColorTexture", {}).get("index", -1),
            mr_tex=pbr.get("metallicRoughnessTexture", {}).get("index", -1),
            clip_alpha=mat.get("alphaMode") == "MASK",
            alpha_cutoff=mat.get("alphaCutoff", 0.5),
        ))

    images: List[np.ndarray] = []
    if load_images:
        images = [_decode_image(_image_bytes(g, img, buffers, base_dir))
                  for img in g.get("images", [])]

    texture_image = []
    texture_wrap = []
    samplers = g.get("samplers", [])
    for tex in g.get("textures", []):
        texture_image.append(tex.get("source", -1))
        wrap = WRAP_REPEAT
        if "sampler" in tex and tex["sampler"] < len(samplers):
            wrap = _GL_WRAP.get(
                samplers[tex["sampler"]].get("wrapS", 10497), WRAP_REPEAT)
        texture_wrap.append(wrap)

    # Flatten the node hierarchy to world-space draw calls (reference
    # tinygltf_load_nodes + update_scene tree walk).
    nodes = g.get("nodes", [])
    draw_calls: List[DrawCall] = []

    def visit(node_id: int, parent: np.ndarray):
        node = nodes[node_id]
        world = parent @ _node_local(node)
        if "mesh" in node:
            draw_calls.append(DrawCall(mesh=node["mesh"], transform=world))
        for child in node.get("children", []):
            visit(child, world)

    scene_id = g.get("scene", 0)
    roots = g.get("scenes", [{}])[scene_id].get("roots", None)
    if roots is None:
        roots = g.get("scenes", [{"nodes": list(range(len(nodes)))}])[
            scene_id].get("nodes", list(range(len(nodes))))
    for r in roots:
        visit(r, np.eye(4, dtype=np.float32))

    def cat(parts, width, dtype):
        if parts:
            return np.concatenate(parts, axis=0).astype(dtype)
        return np.zeros((0, width), dtype)

    return GltfScene(
        positions=cat(positions, 3, np.float32),
        normals=cat(normals, 3, np.float32),
        uvs=cat(uvs, 2, np.float32),
        indices=(np.concatenate(indices) if indices
                 else np.zeros(0, np.uint32)),
        meshes=meshes,
        materials=materials,
        images=images,
        texture_image=texture_image,
        texture_wrap=texture_wrap,
        draw_calls=draw_calls,
        nodes=nodes,
    )
