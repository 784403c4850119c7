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
