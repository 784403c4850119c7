"""Pillow's BILINEAR resize of an RGBA8 image, byte for byte, in numpy.

vkr_tpu's Sponza texture set resizes each image with PIL's
im.resize((tex_size, tex_size), Image.BILINEAR) on an RGBA image
(vkr_tpu/scene/procedural.py:358-360). The card's machine has no PIL, so
this module computes what Pillow 12 computes (Image.resize, libImaging's
Convert.c and Resample.c):

  * RGBA is resized as premultiplied "RGBa": each colour byte becomes
    MULDIV255(v, a) first, and after the resize v' = 255 * v / a with
    integer division, clipped to 255 (alpha 0 and 255 pass the colour
    through);
  * per axis, a triangle filter in float64 with filterscale = max(in /
    out, 1) and support = filterscale: output i is centred at (i + 0.5)
    * in / out, reads inputs xmin = max(int(centre - support + 0.5), 0)
    up to xmax = min(int(centre + support + 0.5), in), weighs input x by
    tri((x - centre + 0.5) / filterscale), and normalises the weights by
    their sum; an upscale takes the same code with filterscale 1;
  * the weights become fixed point with 22 fraction bits, rounded half
    away from zero; each output starts its accumulator at 1 << 21 and is
    acc >> 22 clipped to [0, 255];
  * the horizontal pass runs first, into 8 bits, then the vertical pass,
    and a pass runs only on an axis whose size changes.

Each pass sums its taps as the C code does, in int32, one tap of every
output at a time.
"""

from __future__ import annotations

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _taps(n_in: int, n_out: int):
    """Resample.c's precompute_coeffs and normalize_coeffs_8bpc: per
    output, its first input xmin (n_out,) and its fixed-point bilinear
    weights (n_out, ksize) int32, zero past its last input."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    weights = np.zeros((n_out, ksize), np.int32)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        x = np.arange(xmin, xmax)
        w = 1.0 - np.abs((x - center + 0.5) * (1.0 / filterscale))
        w = np.where(w > 0.0, w, 0.0)
        total = np.cumsum(w)[-1] if len(w) else 0.0  # in order, as C sums
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        first[i] = xmin
        weights[i, :xmax - xmin] = np.where(
            fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5))
    return first, weights


def _pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One 8-bit pass of (H, W, C) u8 along axis (1: horizontal, 0:
    vertical) to n_out samples. The int32 sums cannot overflow: the
    weights sum to about 1 << 22 and the samples are at most 255."""
    n_in = img.shape[axis]
    first, weights = _taps(n_in, n_out)
    shape = list(img.shape)
    shape[axis] = n_out
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    w_shape = [1, 1, 1]
    w_shape[axis] = n_out
    for k in range(weights.shape[1]):
        idx = np.minimum(first + k, n_in - 1)
        taps = np.take(img, idx, axis=axis).astype(np.int32)
        taps *= weights[:, k].reshape(w_shape)
        acc += taps
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _tables():
    """Convert.c's per-byte tables, indexed [alpha, value]: rgbA2rgba's
    MULDIV255(v, a), and rgba2rgbA's CLIP8(255 * v / a) for 0 < a < 255
    with the value passed through where a is 0 or 255."""
    a = np.arange(256, dtype=np.int64)[:, None]
    v = np.arange(256, dtype=np.int64)[None, :]
    t = v * a + 128
    mul = ((t >> 8) + t) >> 8
    div = np.minimum(255 * v // np.maximum(a, 1), 255)
    div = np.where((a == 0) | (a == 255), v, div)
    return mul.astype(np.uint8).ravel(), div.astype(np.uint8).ravel()


_MULDIV255, _UNPREMULTIPLY = _tables()


def _convert(rgba: np.ndarray, table: np.ndarray) -> np.ndarray:
    """rgba with its colour bytes looked up in a flat [alpha, value]
    table."""
    index = rgba.astype(np.uint16)
    index[..., :3] |= index[..., 3:] << 8
    out = np.take(table, index)
    out[..., 3] = rgba[..., 3]
    return out


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """Convert.c's rgbA2rgba ("RGBA" -> "RGBa")."""
    return _convert(rgba, _MULDIV255)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Convert.c's rgba2rgbA ("RGBa" -> "RGBA")."""
    return _convert(rgba, _UNPREMULTIPLY)


def pil_bilinear_resize(rgba: np.ndarray, width: int,
                        height: int) -> np.ndarray:
    """(H, W, 4) u8 -> (height, width, 4) u8, what PIL's
    Image.fromarray(rgba).resize((width, height), Image.BILINEAR) gives.
    The input comes back as it is when the size does not change."""
    rgba = np.asarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if (h, w) == (height, width):
        return rgba
    img = premultiply(rgba)
    if w != width:
        img = _pass(img, width, 1)
    if h != height:
        img = _pass(img, height, 0)
    return unpremultiply(img)
