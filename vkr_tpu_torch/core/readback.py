"""Host readback + capture utilities, as vkr_tpu/core/readback.py has them.

The analog of the reference's ReadBackSystem (image_readback.{hpp,cpp}) and
main.cpp's capture callbacks (main.cpp:118-176): device tensor -> host
bytes -> timestamped PNG / depth CSV under captures/. The PNG is written
here with zlib and struct (the card's machine has no PIL); the sRGB encode
and the u8 rounding run in numpy on the host copy, as vkr_tpu's do, so the
pixels equal vkr_tpu's bit for bit.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_host(array) -> np.ndarray:
    """Blocking readback: a tensor's values once the work that writes it is
    done (the copy to host memory waits for its stream)."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def png_bytes(px, colour_type: int = 6, filters=(0,), extra: bytes = b"",
              level: int = 6) -> bytes:
    """An 8-bit, non-interlaced PNG of px (H, W, channels) u8: row y is
    filtered with filters[y % len(filters)] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth). Every filter predicts from the unfiltered
    neighbours, so all rows filter at once. extra: chunks to put before
    the image data (PLTE, tRNS)."""
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


def png_pixels(array, srgb_encode: bool = False) -> np.ndarray:
    """(H, W[, C]) float [0,1] or u8 -> the (H, W, 3) u8 pixels save_png
    writes: clipped, optionally sRGB-encoded, rounded as (x*255 + 0.5);
    one channel is repeated, a second gets a zero third, a fourth drops."""
    img = to_host(array)
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 1.0)
        if srgb_encode:
            img = np.where(
                img <= 0.0031308, img * 12.92,
                1.055 * img ** (1 / 2.4) - 0.055,
            )
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        img = np.concatenate(
            [img, np.zeros_like(img[..., :1])], axis=-1
        )
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def save_png(array, path: str, srgb_encode: bool = False) -> str:
    """(H, W[, C]) float [0,1] or u8 -> RGB PNG (get_rgba_cb analog)."""
    data = png_bytes(png_pixels(array, srgb_encode), colour_type=2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def save_depth_csv(depth, path: str) -> str:
    """Depth dump in the reference's CSV shape (get_depth_cb,
    main.cpp:118-150): one row per scanline, hex-encoded D24 texels."""
    d = to_host(depth)
    q = np.clip(d, 0.0, 1.0)
    q24 = (q * float((1 << 24) - 1)).astype(np.uint32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("y, " + ",".join(str(x) for x in range(d.shape[1])) + "\n")
        for yrow in range(d.shape[0]):
            f.write(
                str(yrow) + ", "
                + ",".join(format(v, "x") for v in q24[yrow]) + "\n"
            )
    return path


def capture_path(prefix: str, ext: str, directory: str = "captures") -> str:
    """Timestamped capture filename (main.cpp:166-176)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(directory, f"{prefix}-{stamp}.{ext}")


# ---------------------------------------------------------- showcase GIF
# The card's machine has no PIL, so the showcase's LANCZOS downscale and
# GIF writer (vkr_tpu/tools/showcase.py calls PIL's) are here.

_PRECISION_BITS = 32 - 8 - 2  # PIL's 8-bit resample fixed point


def _lanczos3(x):
    """PIL's lanczos filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.sin(np.pi * v) / (np.pi * v)
        return np.where(v == 0.0, 1.0, out)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_taps(n_in: int, n_out: int):
    """(indices (n_out, K), fixed-point weights (n_out, K)) of one axis, as
    PIL's precompute_coeffs and normalize_coeffs_8bpc make them: support
    3 * max(scale, 1), window [int(c - s + 0.5), int(c + s + 0.5)) about
    the centre c = (i + 0.5) * scale, weights normalised to sum 1, then
    rounded to 22 fraction bits away from zero."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centers = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centers + support + 0.5).astype(np.int64),
                      n_in)
    x = xmin[:, None] + np.arange(ksize)[None]
    inside = x < xmax[:, None]
    w = np.where(inside, _lanczos3((x - centers[:, None] + 0.5)
                                   / filterscale), 0.0)
    total = w.sum(1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total == 0.0, 1.0, total), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return np.minimum(x, n_in - 1), fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One PIL 8-bit resample pass along `axis` (0 rows, 1 columns): int32
    sums as PIL's, rounded and clipped to u8."""
    idx, k = _lanczos_taps(img.shape[axis], n_out)
    k = k.astype(np.int32)
    src = np.asarray(img).astype(np.int32)
    shape = list(src.shape)
    shape[axis] = n_out
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    bcast = [None] * src.ndim
    bcast[axis] = slice(None)
    for t in range(idx.shape[1]):
        acc += np.take(src, idx[:, t], axis=axis) * k[:, t][tuple(bcast)]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(img, width: int, height: int) -> np.ndarray:
    """(H, W[, C]) u8 -> (height, width[, C]) u8: PIL's Image.resize with
    LANCZOS (a separable Lanczos-3, support scaled by the downscale
    factor), the horizontal pass first, each pass rounded to u8."""
    out = np.asarray(img, np.uint8)
    if out.shape[1] != width:
        out = _resample_axis(out, width, 1)
    if out.shape[0] != height:
        out = _resample_axis(out, height, 0)
    return out


def median_cut_palette(pixels: np.ndarray, colours: int = 256):
    """A palette of at most `colours` RGB entries for (N, 3) u8 pixels by
    median cut: the box of the widest channel range is split at the
    median of that channel until there are `colours` boxes; each entry is its box's mean.
    Returns (colours, 3) u8 (unused entries black)."""
    def widths(box):
        return box.max(0).astype(int) - box.min(0)

    boxes = [np.asarray(pixels, np.uint8).reshape(-1, 3)]
    spans = [widths(boxes[0])]
    while len(boxes) < colours:
        i = int(np.argmax([w.max() for w in spans]))
        if spans[i].max() <= 0:
            break
        box, span = boxes.pop(i), spans.pop(i)
        ch = int(np.argmax(span))
        median = np.partition(box[:, ch], len(box) // 2)[len(box) // 2]
        # a colour never lands in two boxes: the split is between values
        low = box[:, ch] < median
        if not low.any():
            low = box[:, ch] <= median
        halves = [box[low], box[~low]]
        boxes[i:i] = halves
        spans[i:i] = [widths(h) for h in halves]
    palette = np.zeros((colours, 3), np.uint8)
    for i, b in enumerate(boxes):
        palette[i] = np.round(b.mean(0))
    return palette


def palette_indices(frames: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(..., 3) u8 -> (...) u8 index of the nearest palette entry
    (squared RGB distance), computed once per distinct colour."""
    flat = np.asarray(frames, np.uint8).reshape(-1, 3).astype(np.int32)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse = np.unique(packed, return_inverse=True)
    rgb = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], -1)
    pal = palette.astype(np.int32)
    nearest = np.empty(len(uniq), np.uint8)
    for lo in range(0, len(uniq), 8192):
        d = ((rgb[lo:lo + 8192, None, :] - pal[None]) ** 2).sum(-1)
        nearest[lo:lo + 8192] = d.argmin(1)
    return nearest[inverse].reshape(np.shape(frames)[:-1])


def _lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-length LZW of a frame's palette indices, codes packed
    LSB first: a clear code first, the code width growing to 12 bits, a
    clear code (and a fresh table) when the table is full."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bits = nbits = 0
    size = min_code_size + 1

    def emit(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8

    data = np.asarray(indices, np.uint8).reshape(-1).tolist()
    table = {}
    next_code = eoi + 1
    emit(clear)
    w = data[0]
    for k in data[1:]:
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            next_code = eoi + 1
            size = min_code_size + 1
        w = k
    emit(w)
    emit(eoi)
    if nbits:
        out.append(bits & 255)
    return bytes(out)


def gif_bytes(frames, duration_ms: int, loop: int = 0) -> bytes:
    """An animated GIF89a of (N, H, W, 3) u8 frames: one global 256-colour
    median-cut palette, LZW, the NETSCAPE2.0 loop block. The delay is in
    hundredths of a second, duration_ms // 10 as PIL writes it."""
    frames = np.asarray(frames, np.uint8)
    n, h, w = frames.shape[:3]
    step = max(1, frames[..., 0].size // (1 << 18))
    palette = median_cut_palette(frames.reshape(-1, 3)[::step])
    indices = palette_indices(frames, palette)
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
             palette.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
             + struct.pack("<H", loop) + b"\x00"]
    for i in range(n):
        parts.append(b"\x21\xf9\x04\x00"
                     + struct.pack("<H", duration_ms // 10) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        data = _lzw(indices[i])
        parts.append(b"\x08" + b"".join(
            bytes([len(data[j:j + 255])]) + data[j:j + 255]
            for j in range(0, len(data), 255)) + b"\x00")
    parts.append(b"\x3b")
    return b"".join(parts)
