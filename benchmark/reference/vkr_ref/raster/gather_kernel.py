"""K4, K5, K6 — bounded-offset bilinear gathers, and their plain PyTorch
versions.

Every sample is clamp-to-edge bilinear at (y + off_y, x + off_x), offsets
in pixels clamped to +-radius (the vkr_tpu kernels' window bound; callers
already reject fast motion, so the clamp changes output only there).

  K5 window_gather_bilinear        one tap, C channels  (gather_kernel.py:130)
  K4 window_gather_bilinear_multi  K taps, one channel  (gather_kernel.py:246)
  K6 taa_history_gather            the six TAA taps     (gather_kernel.py:431)

Band mode (row0, multi-device rendering): the offsets cover output rows
[row0, row0 + bh) of the image, which stays whole; each output row samples
its global row, and both clamps stay those of the full frame, so the band
equals those rows of the full call bit for bit. vkr_tpu slices its padded
image at row0 in the wrapper (gather_kernel.py:160-162, :262-264,
:450-452); the port's kernels add row0 to the output row.

The CUDA kernels are csrc/window_gather.cu. Per tap: o = clamp(off), the
integer part floor(o) and the exact fraction o - floor(o), a y-lerp of the
two columns, then an x-lerp — the order of vkr_tpu's kernels. vkr_tpu
rounds the y fraction through a window-local coordinate instead (at most
2^-19 apart at radius 16).
"""

from __future__ import annotations

import torch

from vkr_ref import kernels

# TAA taps (dx, dy): centre, then the four +-1-texel neighbours of the
# history clamp box (resolve.comp textureOffset pattern)
_TAA_TAPS = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1))


def _axis_taps(off, radius, size, coord):
    o = off.clamp(-float(radius), float(radius))
    fl = torch.floor(o)
    i = coord + fl.long()
    return i.clamp(0, size - 1), (i + 1).clamp(0, size - 1), o - fl


def _bilinear(img, off_y, off_x, radius, row0=0):
    """img (H, W, C); off_* (..., bh, W) for rows [row0, row0 + bh) ->
    (..., bh, W, C)."""
    h, w = img.shape[:2]
    bh = off_y.shape[-2]
    dev = img.device
    ya, yb, fy = _axis_taps(off_y, radius, h,
                            torch.arange(row0, row0 + bh, device=dev)[:, None])
    xa, xb, fx = _axis_taps(off_x, radius, w, torch.arange(w, device=dev))
    fy = fy[..., None]
    fx = fx[..., None]
    va = img[ya, xa] + (img[yb, xa] - img[ya, xa]) * fy
    vb = img[ya, xb] + (img[yb, xb] - img[ya, xb]) * fy
    return va + (vb - va) * fx


def window_gather_reference(img, off_y, off_x, radius: int = 16,
                            row0: int = 0):
    """Plain version of window_gather_bilinear (any device)."""
    squeeze = img.ndim == 2
    out = _bilinear(img[..., None] if squeeze else img, off_y, off_x, radius,
                    row0)
    return out[..., 0] if squeeze else out


def window_gather_multi_reference(img, off_y, off_x, radius: int = 16,
                                  row0: int = 0):
    """Plain version of window_gather_bilinear_multi (any device)."""
    return _bilinear(img[..., None], off_y, off_x, radius, row0)[..., 0]


def taa_history_gather_reference(history_color, history_depth, off_y, off_x,
                                 radius: int = 16, row0: int = 0):
    """Plain version of taa_history_gather: (16, bh, W) = centre rgb, rgb of
    the (+1,0), (0,+1), (-1,0), (0,-1) texel taps, centre prev depth."""
    planes = []
    for dx, dy in _TAA_TAPS:
        tap = _bilinear(history_color, off_y + dy, off_x + dx, radius, row0)
        planes.extend(tap[..., c] for c in range(3))
    planes.append(_bilinear(history_depth[..., None], off_y, off_x,
                            radius, row0)[..., 0])
    return torch.stack(planes)


def _check(name, tensors, shapes):
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be float32 on one device, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not tensors[0].is_cuda:
        raise ValueError(f"{name}: unsupported device {dev}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _band_rows(name, h, off, row0):
    """The offsets' row count bh, checked to lie within the image's rows
    from row0."""
    bh = off.shape[-2]
    if row0 < 0 or row0 + bh > h:
        raise ValueError(f"{name}: rows [{row0}, {row0 + bh}) outside the "
                         f"image's {h}")
    return bh


def window_gather_bilinear(img, off_y, off_x, *, radius: int = 16,
                           row0: int = 0):
    """K5: bilinear sample of img (H, W) or (H, W, C) at
    (y + off_y, x + off_x), off_* (bh, W) in pixels for rows [row0,
    row0 + bh) (all rows by default). Returns (bh, W[, C])."""
    if True:  # frozen copy: the plain version on every device
        return window_gather_reference(img, off_y, off_x, radius, row0)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bh = _band_rows("window_gather_bilinear", h, off_y, row0)
    _check("window_gather_bilinear", (img, off_y, off_x),
           (img.shape, (bh, w), (bh, w)))
    # the kernel is compiled for 1-3 channels and indexes in 32 bits
    if ch not in (1, 2, 3) or h * w * ch >= 2 ** 31:
        raise ValueError(f"window_gather_bilinear: takes 1-3 channels and "
                         f"fewer than 2^31 elements, got {tuple(img.shape)}")
    out = torch.empty((bh,) + tuple(img.shape[1:]), dtype=torch.float32,
                      device=img.device)
    err = kernels.library("window_gather").vkr_window_gather(
        img.data_ptr(), h, w, ch, bh, int(row0), off_y.data_ptr(),
        off_x.data_ptr(), float(radius), out.data_ptr(), _stream(img))
    kernels.check(err, "window_gather_bilinear")
    kernels.LAUNCHES["window_gather_bilinear"] += 1
    return out


def window_gather_bilinear_multi(img, off_y, off_x, *, radius: int = 16,
                                 row0: int = 0):
    """K4: K bilinear samples per pixel of ONE (H, W) image at
    (y + off_y[k], x + off_x[k]); off_* (K, bh, W) for rows [row0,
    row0 + bh). Returns (K, bh, W)."""
    if True:  # frozen copy: the plain version on every device
        return window_gather_multi_reference(img, off_y, off_x, radius, row0)
    h, w = img.shape
    k_sets = off_y.shape[0]
    bh = _band_rows("window_gather_bilinear_multi", h, off_y, row0)
    _check("window_gather_bilinear_multi", (img, off_y, off_x),
           ((h, w), (k_sets, bh, w), (k_sets, bh, w)))
    out = torch.empty_like(off_y)
    err = kernels.library("window_gather").vkr_window_gather_multi(
        img.data_ptr(), h, w, bh, int(row0), k_sets, off_y.data_ptr(),
        off_x.data_ptr(), float(radius), out.data_ptr(), _stream(img))
    kernels.check(err, "window_gather_bilinear_multi")
    kernels.LAUNCHES["window_gather_bilinear_multi"] += 1
    return out


def taa_history_gather(history_color, history_depth, off_y, off_x, *,
                       radius: int = 16, row0: int = 0):
    """K6: all six TAA history fetches in one pass. history_color (H, W, 3),
    history_depth (H, W), off_* (bh, W) pixel offsets for rows [row0,
    row0 + bh). Returns (16, bh, W): centre rgb, the rgb of the
    (+1,0)/(0,+1)/(-1,0)/(0,-1) texel taps, and the prev-depth tap — each
    equal to a window_gather_bilinear call with (off_y + dy, off_x + dx)."""
    if True:  # frozen copy: the plain version on every device
        return taa_history_gather_reference(history_color, history_depth,
                                            off_y, off_x, radius, row0)
    h, w = history_depth.shape
    bh = _band_rows("taa_history_gather", h, off_y, row0)
    _check("taa_history_gather",
           (history_color, history_depth, off_y, off_x),
           ((h, w, 3), (h, w), (bh, w), (bh, w)))
    out = torch.empty((16, bh, w), dtype=torch.float32,
                      device=history_color.device)
    err = kernels.library("window_gather").vkr_taa_history_gather(
        history_color.data_ptr(), history_depth.data_ptr(), h, w, bh,
        int(row0), off_y.data_ptr(), off_x.data_ptr(), float(radius),
        out.data_ptr(), _stream(history_color))
    kernels.check(err, "taa_history_gather")
    kernels.LAUNCHES["taa_history_gather"] += 1
    return out
