"""The port's image decoders against PIL's Image.open(...).convert("RGBA"),
which is what vkr_tpu's glTF loader calls (vkr_tpu/scene/gltf.py:117-122):
vkr_tpu_torch/scene/jpeg.py:decode_jpeg and scene/gltf.py:decode_png.

Every JPEG form PIL can write is held bit for bit, on small images of odd
sizes (37x29 and 61x45, smooth and noise) at qualities 50, 90 and 100:
baseline and progressive scans, 4:2:0, 4:2:2 and 4:4:4, optimised tables,
restart markers, greyscale, CMYK and SOF1 with 16-bit DQT; 4:4:0 and
4:1:1, which PIL cannot write, on small committed files that OpenCV
wrote (tests/torch_images/make_images.py); and the forms neither writes
(ROADMAP item 18: YCCK, arithmetic coding, lossless), on committed files
of make_images.py's own encoder, with the forms PIL refuses refused. PNG is held
at every colour type and bit depth, plain and Adam7, with tRNS; the test
writes the PNG bytes itself (zlib and filter bytes). The committed JPEG
textures of chip_smoke.py's JPEG glTF phase are checked against their
digests through PIL (the port decodes them on the card: no 1024² decode
runs here), and a glTF scene with JPEG textures compiles to the same
CompiledScene through both packages."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from vkr_tpu_torch.core.readback import png_chunk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "tests", "torch_images")
SIZES = ((29, 37), (45, 61))


def _smooth(h, w, seed):
    """Gradients and mild noise: what a photograph's blocks look like."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + seed),
                     128 + 80 * np.cos(y / 7),
                     128 + 60 * np.sin((x + y) / 9)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _noise(h, w, seed):
    """Uniform noise: at quality 100 its blocks overshoot 0..255, which
    the post-IDCT range-limit table clips."""
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                np.uint8)


def _jpeg(img, mode, **options):
    out = io.BytesIO()
    Image.fromarray(img).convert(mode).save(out, "JPEG", **options)
    return out.getvalue()


def _pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _markers(data):
    """The marker codes up to the first scan's."""
    out, pos = [], 2
    while pos < len(data) and data[pos] == 0xFF:
        code = data[pos + 1]
        out.append(code)
        if code == 0xDA:
            break
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return out


# form -> (PIL mode, save options, the SOF marker it writes)
JPEG_FORMS = {
    "baseline-420": ("RGB", dict(subsampling="4:2:0"), 0xC0),
    "baseline-422": ("RGB", dict(subsampling="4:2:2"), 0xC0),
    "baseline-444": ("RGB", dict(subsampling="4:4:4"), 0xC0),
    "progressive-420": ("RGB", dict(progressive=True,
                                    subsampling="4:2:0"), 0xC2),
    "progressive-422": ("RGB", dict(progressive=True,
                                    subsampling="4:2:2"), 0xC2),
    "progressive-444": ("RGB", dict(progressive=True,
                                    subsampling="4:4:4"), 0xC2),
    "optimised": ("RGB", dict(optimize=True), 0xC0),
    "restart-3-mcus": ("RGB", dict(restart_marker_blocks=3), 0xC0),
    "progressive-restart-rows": ("RGB", dict(progressive=True,
                                             restart_marker_rows=1), 0xC2),
    "grey": ("L", {}, 0xC0),
    "grey-progressive": ("L", dict(progressive=True), 0xC2),
    "cmyk": ("CMYK", {}, 0xC0),
}


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("form", sorted(JPEG_FORMS))
def test_jpeg_matches_pil(form, quality):
    """Bit-equal to PIL over libjpeg-turbo on both sizes, smooth and
    noise; the file is the form it is named for (its SOF marker, a DRI
    where it restarts)."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    mode, options, sof = JPEG_FORMS[form]
    for i, (h, w) in enumerate(SIZES):
        for make in (_smooth, _noise):
            data = _jpeg(make(h, w, i), mode, quality=quality, **options)
            markers = _markers(data)
            assert sof in markers
            assert (0xDD in markers) == ("restart" in form)
            got = decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == (h, w, 4)
            np.testing.assert_array_equal(got, _pil_rgba(data),
                                          err_msg=f"{make.__name__} {h}x{w}")


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_sof1_16bit_tables(mode):
    """Quantisation steps above 255: PIL writes SOF1 with a 16-bit DQT."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    coarse = [300 + k for k in range(64)]
    tables = [coarse, [2] * 64] if mode == "RGB" else [coarse]
    data = _jpeg(_smooth(29, 37, 5), mode, qtables=tables)
    assert 0xC1 in _markers(data)
    pq = data[data.index(b"\xff\xdb") + 4] >> 4
    assert pq == 1
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgba(data))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (3, 2), (9, 17), (17, 4)])
def test_jpeg_tiny_sizes(h, w):
    """Sizes under one MCU and chroma planes two samples wide or less,
    where libjpeg-turbo replicates instead of its fancy upsampling."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    img = _noise(h, w, h * 100 + w)
    for sub in ("4:2:0", "4:2:2"):
        for progressive in (False, True):
            data = _jpeg(img, "RGB", quality=90, subsampling=sub,
                         progressive=progressive)
            np.testing.assert_array_equal(decode_jpeg(data),
                                          _pil_rgba(data),
                                          err_msg=f"{sub} {progressive}")


@pytest.mark.parametrize("name", [
    "sampling_440.jpg", "sampling_440_progressive.jpg", "sampling_411.jpg",
    "sampling_411_progressive.jpg"])
def test_jpeg_samplings_pil_cannot_write(name):
    """4:4:0 (libjpeg-turbo's 1x2 fancy upsampler) and 4:1:1 (its
    generic replication), baseline and progressive, bit-equal to PIL."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    with open(os.path.join(IMAGES, name), "rb") as f:
        data = f.read()
    sampling = name[len("sampling_"):][:3]
    y = data[data.index(b"\xff\xc0" if "progressive" not in name
                        else b"\xff\xc2") + 11]
    assert y == {"440": 0x12, "411": 0x41}[sampling]
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgba(data))


def _unknown_component():
    data = bytearray(_jpeg(_smooth(16, 16, 3)[..., 0], "L", quality=75))
    sos = data.index(b"\xff\xda")
    data[sos + 5] = 9  # the scan's component id; the frame has only 1
    return bytes(data)


@pytest.mark.parametrize("make,match", [
    (lambda: b"\xff\xd8\xff\xd9", "without a frame header"),
    (lambda: b"\xff\xd8\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00",
     "scan before its frame header"),
    (_unknown_component, "no such component")],
    ids=["no-frame", "scan-first", "unknown-component"])
def test_malformed_jpeg_raises(make, match):
    """Malformed headers raise ValueError, as PIL raises on them."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    data = make()
    with pytest.raises(OSError):
        _pil_rgba(data)
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


def test_decode_image_dispatches_on_the_signature():
    """_decode_image reads JPEG and PNG by their first bytes and refuses
    anything else."""
    from vkr_tpu_torch.scene.gltf import _decode_image

    img = _smooth(29, 37, 9)
    jpeg = _jpeg(img, "RGB", quality=80)
    np.testing.assert_array_equal(_decode_image(jpeg), _pil_rgba(jpeg))
    png = _png_bytes(img, 8, 2)
    np.testing.assert_array_equal(_decode_image(png), _pil_rgba(png))
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        _decode_image(b"GIF89a" + bytes(16))


# ------------------------------------------------------------------ PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(samples, depth):
    """(h, w, c) samples -> (h, row bytes) u8, big-endian, MSB first."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.int64)
    padded[:, :w] = samples[..., 0]
    shifts = depth * np.arange(per - 1, -1, -1)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter(rows, bpp, kinds):
    """PNG row filters on bytes; the left neighbour is bpp bytes back."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    pa, pb = np.abs(up - up_left), np.abs(left - up_left)
    pc = np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    pred = np.choose(kinds[:, None], [np.zeros_like(x), left, up,
                                      (left + up) >> 1, paeth])
    return np.concatenate([kinds[:, None].astype(np.uint8),
                           ((x - pred) & 255).astype(np.uint8)], 1)


def _png_bytes(samples, depth, ctype, interlace=0, extra=b""):
    """A PNG of (h, w[, c]) samples; rows take the five filters in turn
    (counted across the Adam7 passes)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    raw, row = [], 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            kinds = (np.arange(row, row + sub.shape[0]) % 5).astype(np.uint8)
            row += sub.shape[0]
            raw.append(_filter(_pack(sub, depth), bpp, kinds).tobytes())
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", header) + extra
            + png_chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + png_chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_matches_pil(ctype, depth, interlace):
    """Every colour type at every bit depth, plain and Adam7 (sizes with
    empty passes included), without tRNS, with a key that some pixel
    matches and with a random key; palettes with partial tRNS."""
    from vkr_tpu_torch.scene.gltf import decode_png

    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    c = _CHANNELS[ctype]
    for h, w in ((1, 1), (3, 2), (5, 7), (19, 23), (9, 1)):
        for trns in range(3):
            samples = rng.integers(0, 1 << depth, (h, w, c))
            extra = b""
            if ctype == 3:
                extra = png_chunk(b"PLTE", rng.integers(
                    0, 256, 3 << depth, np.uint8).tobytes())
                if trns:
                    extra += png_chunk(b"tRNS", bytes([7, 200]))
            elif ctype in (0, 2) and trns:
                key = (samples[0, 0] if trns == 1
                       else rng.integers(0, 1 << depth, c))
                extra = png_chunk(b"tRNS", struct.pack(
                    ">" + "H" * c, *map(int, key)))
            data = _png_bytes(samples, depth, ctype, interlace, extra)
            got = decode_png(data)
            assert got.dtype == np.uint8 and got.shape == (h, w, 4)
            np.testing.assert_array_equal(got, _pil_rgba(data),
                                          err_msg=f"{h}x{w} tRNS {trns}")


def test_png_pil_quirks():
    """PIL's modes, spelled out: 16-bit grey clips (6211 -> 255), other
    16-bit samples keep their high byte (53932 -> 210), 2- and 4-bit grey
    scale by 85 and 17, 1-bit grey is 0 or 255, and a tRNS key is
    compared on its low byte with the 8-bit values (1-bit grey: any
    nonzero key marks white)."""
    from vkr_tpu_torch.scene.gltf import decode_png

    cases = [
        (np.array([[6211, 200]]), 16, 0, b"", [255, 200], [255, 255]),
        (np.array([[[53932, 0, 65535]]]), 16, 2, b"", [[210, 0, 255]],
         [255]),
        (np.array([[0, 1, 2, 3]]), 2, 0, b"", [0, 85, 170, 255],
         [255] * 4),
        (np.array([[1, 15]]), 4, 0, struct.pack(">H", 256 + 255),
         [17, 255], [255, 0]),
        (np.array([[0, 1]]), 1, 0, struct.pack(">H", 256), [0, 255],
         [255, 0]),
    ]
    for samples, depth, ctype, key, grey, alpha in cases:
        extra = png_chunk(b"tRNS", key) if key else b""
        data = _png_bytes(samples, depth, ctype, 0, extra)
        got = decode_png(data)
        np.testing.assert_array_equal(got, _pil_rgba(data))
        values = got[0, :, 0] if ctype == 0 else got[0, :, :3]
        np.testing.assert_array_equal(values, np.asarray(grey).reshape(
            values.shape))
        np.testing.assert_array_equal(got[0, :, 3], alpha)


# ------------------------------------------------- the committed textures

def _digests():
    with open(os.path.join(IMAGES, "digests.json")) as f:
        return json.load(f)


def _textures():
    """digests.json's entries of the 8 colonnade textures."""
    return {k: v for k, v in _digests().items()
            if isinstance(v, dict) and "texture" in v}


@pytest.mark.parametrize("name", sorted(_textures()))
def test_committed_digests(name):
    """digests.json holds PIL's convert("RGBA") of each committed JPEG, at
    chip_smoke.py's texture sizes; chip_smoke.py's JPEG glTF phase holds
    the port's decode to it on the card."""
    want = _digests()[name]
    with open(os.path.join(IMAGES, name), "rb") as f:
        data = f.read()
    rgba = np.ascontiguousarray(_pil_rgba(data))
    assert list(rgba.shape) == want["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == want["rgba_sha256"]
    t = want["texture"]
    wide = t in chip_smoke.GLTF_WIDE
    assert rgba.shape[:2] == ((512, 2048) if wide else (1024, 1024))
    assert (0xC2 in _markers(data)) == ("progressive" in want["form"])


def test_committed_set_mixes_the_forms():
    """The eight files cover the forms the card phase needs and stay
    under 2 MB."""
    digests = _textures()
    forms = " | ".join(v["form"] for v in digests.values())
    for form in ("baseline 4:2:0", "progressive 4:2:2", "4:4:4, optimised",
                 "restart", "greyscale", "CMYK"):
        assert form in forms, form
    assert sorted(v["texture"] for v in digests.values()) == list(range(8))
    assert sum(os.path.getsize(os.path.join(IMAGES, k))
               for k in digests) < 2_000_000


# ------------------------------------------------ the item-18 JPEG forms

def _item18(pil):
    return sorted(k for k, v in _digests().items()
                  if k.startswith("item18_") and v["pil"] == pil)


def _committed(name):
    with open(os.path.join(IMAGES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", _item18("decodes"))
def test_item18_forms_match_pil(name):
    """The JPEG forms PIL decodes and writes none of (make_images.py's own
    encoder wrote them: YCCK, arithmetic sequential and progressive with
    restarts and DAC, lossless at every predictor, point transform,
    restarts, RGB, 4:2:0 and CMYK), bit-equal to PIL and to the digest
    of PIL's bytes in digests.json."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    data = _committed(name)
    want = _pil_rgba(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and list(got.shape) == _digests()[name][
        "shape"]
    np.testing.assert_array_equal(got, want)
    assert (hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
            == _digests()[name]["rgba_sha256"])


@pytest.mark.parametrize("name", _item18("refuses"))
def test_item18_forms_pil_refuses(name):
    """Where PIL refuses a form (lossless YCbCr and YCCK, arithmetic
    lossless, 12-bit, hierarchical, a DNL height), the port raises
    NotImplementedError naming ROADMAP's item 18."""
    from vkr_tpu_torch.scene.jpeg import decode_jpeg

    data = _committed(name)
    with pytest.raises(OSError):
        _pil_rgba(data)
    with pytest.raises(NotImplementedError, match="item 18"):
        decode_jpeg(data)


def test_item18_set_covers_the_forms():
    """Every form of the item, in both outcomes, and the two 256x256
    files the Sponza stand-in takes."""
    d = _digests()
    forms = " | ".join(d[k]["form"] for k in _item18("decodes"))
    for form in ("YCCK", "SOF9", "SOF10", "restart", "DAC",
                 *(f"predictor {p}" for p in range(1, 8)),
                 "point transform 2", "RGB", "4:2:0", "CMYK", "256x256"):
        assert form in forms, form
    refused = " | ".join(d[k]["form"] for k in _item18("refuses"))
    for form in ("SOF11", "12-bit", "hierarchical", "DNL", "JFIF",
                 "YCCK"):
        assert form in refused, form
    markers = {k: _markers(_committed(k)) for k in _item18("decodes")}
    assert {0xC9, 0xCA, 0xC3} <= set().union(*markers.values())


# ------------------------------------------------ a glTF with JPEG textures

@pytest.fixture(scope="module")
def jpeg_gltf(tmp_path_factory):
    """The 8-column colonnade at 32x32 textures (64x16 for the CLAMP
    three), each texture a JPEG of another form."""
    from vkr_tpu_torch.scene.procedural import build_colonnade

    sc = build_colonnade(columns=8, tessellation=8, tex_size=32)
    imgs = list(sc.images)
    for t in chip_smoke.GLTF_WIDE:
        imgs[t] = np.repeat(imgs[t][::2], 2, axis=1)
    forms = sorted(JPEG_FORMS)
    data = []
    for t, img in enumerate(imgs):
        mode, options, _ = JPEG_FORMS[forms[t % len(forms)]]
        data.append(_jpeg(img[..., :3], mode, quality=85, **options))
    wraps = [0, 0, 0, 1, 1, 0, 0, 1]
    return chip_smoke.write_gltf(str(tmp_path_factory.mktemp("jpeg")), sc,
                                 data, wraps, data_uri=(5,),
                                 buffer_view=(6,))


@pytest.fixture(scope="module")
def native_lib():
    """vkr_tpu's native asset pipeline, built as tests/test_native.py
    builds it (tests/test_torch_gltf.py explains why)."""
    import subprocess

    subprocess.run(["make", "-C", os.path.join(REPO, "vkr_tpu", "native")],
                   check=True, capture_output=True)
    from vkr_tpu import native

    native._lib = None
    assert native.available()


@pytest.mark.parametrize("native_sizes", [False, True],
                         ids=["uniform", "native"])
def test_jpeg_gltf_compiles_equal(jpeg_gltf, native_lib, native_sizes):
    """load_scene through the port and through vkr_tpu: the decoded
    images equal, and every CompiledScene field (tex_mips is None in the
    port's native mode, as tests/test_torch_gltf.py explains)."""
    from vkr_tpu.scene.gltf import load_gltf as j_gltf
    from vkr_tpu.scene.scene import load_scene as j_load
    from vkr_tpu_torch.scene.gltf import load_gltf as t_gltf
    from vkr_tpu_torch.scene.scene import load_scene as t_load

    for a, b in zip(t_gltf(jpeg_gltf).images, j_gltf(jpeg_gltf).images):
        np.testing.assert_array_equal(a, b)
    got = t_load(jpeg_gltf, tex_size=32, native_sizes=native_sizes)
    want = j_load(jpeg_gltf, tex_size=32, native_sizes=native_sizes)
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "tex_mips" and native_sizes:
            assert g is None and w is not None
        elif f in ("tex_mips", "tex_images"):
            assert (g is None) == (w is None), f
            if g is not None:
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
