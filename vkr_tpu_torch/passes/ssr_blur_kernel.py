"""R2 — the SSR blur's 23x23 bilateral gather (blur.comp's roughness-
adaptive gaussian with depth and normal weights), and its plain PyTorch
version.

  R2 ssr_blur   csrc/ssr_blur.cu; vkr_tpu computes it in jnp
                (vkr_tpu/passes/ssr.py:858, a lax.fori_loop over the taps)

passes/ssr.py:ssr_blur computes the sigma plane and decodes the normals,
calls ssr_blur for the blurred colour, then blends the reprojected
history. Both versions add the 529 taps one by one in vkr_tpu's order
(k = (j + 11) * 23 + (i + 11): j outer, i inner), so the CUDA kernel
equals the plain version bit for bit; CPU tensors take the plain version.

Band mode (row0, multi-device rendering): sigma and the output cover rows
[row0, row0 + h) of a frame whose reflections, depth and normals stay
whole; the 11-texel halo replicates the frame's edges, not the band's, so
a band equals those rows of the whole call bit for bit.
"""

from __future__ import annotations

import math

import torch

from vkr_tpu_torch import kernels

MAX_BLUR_RADIUS = 11  # sigma <= 4 -> r = floor(12 - eps)


def _halo(a, row0: int, h: int):
    """Rows [row0 - pad, row0 + h + pad) and columns [-pad, w + pad) of a
    (H, w, ...), the frame's edge rows and columns replicated."""
    pad = MAX_BLUR_RADIUS
    rows = (torch.arange(h + 2 * pad, device=a.device) + row0 - pad).clamp(
        0, a.shape[0] - 1)
    cols = (torch.arange(a.shape[1] + 2 * pad, device=a.device) - pad).clamp(
        0, a.shape[1] - 1)
    return a.index_select(0, rows).index_select(1, cols)


def ssr_blur_reference(reflections, depth, normal, sigma, row0: int = 0):
    """ssr_blur's plain version: the blurred colour (h, w, 3) of rows
    [row0, row0 + h) (h = sigma's rows). reflections (H, w, 3), depth
    (H, w) and the decoded normals (H, w, 3) are the whole frame's; sigma
    (h, w) is the band's.

    Each tap (i, j) inside the pixel's radius r = floor(3 sigma - 0.01)
    weighs its reflection by exp(-(i^2 + j^2) / (2 sigma^2)) times the
    depth weight max(1 - 1000 |d - d_tap| / max(|d|, 1e-20), 0) times the
    normal weight max(n . n_tap, 0); a tap outside weighs it by 0 (so a
    non-finite reflection there still makes the colour NaN, as vkr_tpu's
    does). blur.comp's gaussian prefactor 1/(2 pi sigma^2) multiplies
    every tap equally and cancels in colour / weight sum, so it is not
    computed; it rescales the weight floor instead: max(g ws, 0.001) = g
    max(ws, 0.001 / g)."""
    h, w = sigma.shape
    pad = MAX_BLUR_RADIUS
    side = 2 * pad + 1
    refl_p = _halo(reflections, row0, h)
    depth_p = _halo(depth, row0, h)
    normal_p = _halo(normal, row0, h)
    depth_c = depth[row0:row0 + h]
    n_c = normal[row0:row0 + h]
    depth_abs = depth_c.abs().clamp(min=1e-20)
    r_pix = torch.floor(3.0 * sigma - 0.01)
    e = 2.0 * sigma * sigma

    color = torch.zeros((h, w, 3), dtype=torch.float32, device=sigma.device)
    weight_sum = torch.zeros((h, w), dtype=torch.float32,
                             device=sigma.device)
    for k in range(side * side):
        j, i = k // side - pad, k % side - pad
        rows = slice(pad + j, pad + j + h)
        cols = slice(pad + i, pad + i + w)
        p_depth = depth_p[rows, cols]
        p_norm = normal_p[rows, cols]
        in_r = (abs(i) <= r_pix) & (abs(j) <= r_pix)
        bw = torch.clamp(1.0 - 1000.0 * (depth_c - p_depth).abs()
                         / depth_abs, min=0.0)
        nw = torch.clamp(n_c[..., 0] * p_norm[..., 0]
                         + n_c[..., 1] * p_norm[..., 1]
                         + n_c[..., 2] * p_norm[..., 2], min=0.0)
        # a tensor numerator: PyTorch divides a Python scalar by a tensor
        # as a reciprocal times the scalar, two roundings
        g = torch.exp(torch.full_like(e, -float(i * i + j * j)) / e)
        wgt = torch.where(in_r, g * bw * nw, 0.0)
        color = color + refl_p[rows, cols] * wgt[..., None]
        weight_sum = weight_sum + wgt
    floor = 0.001 * (2.0 * math.pi) * sigma * sigma
    return color / torch.maximum(weight_sum, floor)[..., None]


def ssr_blur(reflections, depth, normal, sigma, row0: int = 0):
    """R2: the blurred colour (h, w, 3) of rows [row0, row0 + h), as
    ssr_blur_reference computes it; csrc/ssr_blur.cu on CUDA tensors,
    one launch on the current stream and nothing read back."""
    if sigma.device.type == "cpu":
        return ssr_blur_reference(reflections, depth, normal, sigma, row0)
    _check(reflections, depth, normal, sigma, row0)
    H, w = depth.shape
    h = sigma.shape[0]
    out = torch.empty((h, w, 3), dtype=torch.float32, device=sigma.device)
    err = kernels.library("ssr_blur").vkr_ssr_blur(
        reflections.data_ptr(), depth.data_ptr(), normal.data_ptr(),
        sigma.data_ptr(), H, w, int(row0), h, out.data_ptr(),
        torch.cuda.current_stream(sigma.device).cuda_stream)
    kernels.check(err, "ssr_blur")
    kernels.LAUNCHES["ssr_blur"] += 1
    return out


def _check(reflections, depth, normal, sigma, row0):
    """Raise on what csrc/ssr_blur.cu does not take: reflections (H, w, 3),
    depth (H, w), normals (H, w, 3) and sigma (h, w) as contiguous float32
    on one CUDA device, rows [row0, row0 + h) within the frame's H, fewer
    than 2^31 elements a plane."""
    H, w = depth.shape[:2]
    h = sigma.shape[0]
    shapes = ((H, w, 3), (H, w), (H, w, 3), (h, w))
    for t, shape in zip((reflections, depth, normal, sigma), shapes):
        if (t.device != sigma.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"ssr_blur: reflections (H, w, 3), depth (H, w), normals "
                f"(H, w, 3) and sigma (h, w) must be contiguous float32 on "
                f"one device; want {shape}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if row0 < 0 or row0 + h > H or 3 * H * w >= 2 ** 31:
        raise ValueError(f"ssr_blur: rows [{row0}, {row0 + h}) of a frame "
                         f"of {H} rows, {3 * H * w} elements a plane (fewer "
                         f"than 2^31)")
    if not sigma.is_cuda:
        raise ValueError(f"ssr_blur: unsupported device {sigma.device}")
