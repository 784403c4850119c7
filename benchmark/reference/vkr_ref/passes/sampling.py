"""Image sampling helpers shared by the image-space passes.

The equivalent of the GLSL texture() / textureLod() calls against render
targets (DEFAULT_SAMPLER: linear filter, clamp-to-edge — samplers.hpp:36-50)
over (H, W[, C]) tensors with uv in [0, 1].
"""

from __future__ import annotations

import torch

from vkr_ref.raster import gather_kernel as _gather


def _prep(img):
    squeeze = img.ndim == 2
    return (img[..., None] if squeeze else img), squeeze


def bilinear_sample(img, uv):
    """texture(img, uv) with linear filter + clamp-to-edge.

    img: (H, W) or (H, W, C); uv: (..., 2) in [0,1].
    """
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()

    def tap(xi, yi):
        return img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    t00 = tap(x0, y0)
    t10 = tap(x0 + 1, y0)
    t01 = tap(x0, y0 + 1)
    t11 = tap(x0 + 1, y0 + 1)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    out = top + (bot - top) * fy
    return out[..., 0] if squeeze else out


def nearest_sample(img, uv, offset_texels=None):
    """texelFetch-style nearest sampling with clamp-to-edge.

    img: (H, W) or (H, W, C); uv: (..., 2) in [0,1]; offset_texels: an
    optional (dx, dy) added to the texel before the clamp."""
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    x = torch.floor(uv[..., 0] * w).to(torch.int32)
    y = torch.floor(uv[..., 1] * h).to(torch.int32)
    if offset_texels is not None:
        x = x + offset_texels[0]
        y = y + offset_texels[1]
    out = img[y.clamp(0, h - 1).long(), x.clamp(0, w - 1).long()]
    return out[..., 0] if squeeze else out


def texel_fetch(img, x, y):
    """texelFetch(img, ivec2(x, y)) with clamp-to-edge."""
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    out = img[torch.as_tensor(y).clamp(0, h - 1).long(),
              torch.as_tensor(x).clamp(0, w - 1).long()]
    return out[..., 0] if squeeze else out


def upsample_half_bilinear(img_half, texel_offset=(0, 0)):
    """Dense 2x bilinear upsample of a half-res target sampled at full-res
    pixel centers (optionally with a half-res texel offset) — the regular
    structure of texture(half_tex, full_uv) with linear filtering.

    Full pixel x maps to half coordinate x/2 - 0.25: even pixels blend
    columns (x/2 - 1, x/2) with weights (0.25, 0.75); odd pixels blend
    (x/2, x/2 + 1) with (0.75, 0.25). Same along y. Edges clamp.
    """
    img, squeeze = _prep(img_half)
    ox, oy = int(texel_offset[0]), int(texel_offset[1])
    h, w, c = img.shape

    def axis_interp(a, axis, off):
        n = a.shape[axis]

        def shifted(k):  # a[clamp(i + k)] along axis
            idx = (torch.arange(n, device=a.device) + k).clamp(0, n - 1)
            return a.index_select(axis, idx)

        lo, mid, hi = shifted(off - 1), shifted(off), shifted(off + 1)
        return 0.25 * lo + 0.75 * mid, 0.75 * mid + 0.25 * hi

    e_y, o_y = axis_interp(img, 0, oy)
    rows = torch.stack([e_y, o_y], dim=1).reshape(2 * h, w, c)
    e_x, o_x = axis_interp(rows, 1, ox)
    full = torch.stack([e_x, o_x], dim=2).reshape(2 * h, 2 * w, c)
    return full[..., 0] if squeeze else full


def downsample_full_to_half(img_full):
    """Dense equivalent of bilinear-sampling a full-res image at half-res
    pixel centers: full coordinate 2x + 0.5 -> equal-weight 2x2 average."""
    img, squeeze = _prep(img_full)
    h, w, c = img.shape
    h2, w2 = h // 2, w // 2
    out = img[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2, c).mean(dim=(1, 3))
    return out[..., 0] if squeeze else out


def downsample_full_to_half_corner(img_full):
    """Dense equivalent of bilinear-sampling a full-res image at half-res
    CORNER-convention uv (uv = pixel/size, as sssr filter.comp uses): full
    coordinate 2x - 0.5 -> equal-weight average of texels (2x-1, 2x),
    clamped at the edge."""
    img, squeeze = _prep(img_full)

    def shift_avg(a, dim):
        shifted = torch.cat([a.narrow(dim, 0, 1),
                             a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)
        return 0.5 * (shifted + a)

    out = shift_avg(shift_avg(img, 0), 1)[::2, ::2]
    return out[..., 0] if squeeze else out


def quad_pack(img):
    """Pack each texel's 2x2 bilinear footprint into one row:
    out[y, x] = [p(y,x), p(y,x+1), p(y+1,x), p(y+1,x+1)] per channel
    (edge-clamped)."""
    img, _ = _prep(img)
    xr = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    yd = torch.cat([img[1:], img[-1:]], dim=0)
    yxd = torch.cat([xr[1:], xr[-1:]], dim=0)
    return torch.cat([img, xr, yd, yxd], dim=-1)


def bilinear_from_quad(qimg, channels: int, uv):
    """texture(img, uv) from a quad_pack'ed image (H, W, 4*C): one row
    fetch per sample. Returns (..., C)."""
    h, w = qimg.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    # Left/top edge: both hardware taps clamp to texel 0, so the lerp
    # weight must collapse to the first packed tap.
    fx = torch.where(x0 < 0, 0.0, x - x0)[..., None]
    fy = torch.where(y0 < 0, 0.0, y - y0)[..., None]
    rows = qimg[y0.long().clamp(0, h - 1), x0.long().clamp(0, w - 1)]
    rows = rows.float()
    c = channels
    t00 = rows[..., 0 * c: 1 * c]
    t10 = rows[..., 1 * c: 2 * c]
    t01 = rows[..., 2 * c: 3 * c]
    t11 = rows[..., 3 * c: 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def reproject_bilinear(img, uv_offset, *, radius: int = 16,
                       texel_offset=None, use_kernel: bool = True,
                       row0: int = 0):
    """Bilinear sample at (pixel uv + uv_offset), the reprojection pattern
    of TAA / temporal accumulation, through the window-gather kernel (K5):
    offsets clamped to +-radius px. texel_offset: optional (dx, dy)
    constant texel offset (textureOffset analog). use_kernel=False takes
    K5's plain version on any device (vkr_tpu's use_kernel=False).
    row0 (band mode, vkr_tpu sampling.py:212-240): uv_offset covers rows
    [row0, row0 + bh) of the whole img."""
    h, w = img.shape[:2]
    off_x = uv_offset[..., 0] * w
    off_y = uv_offset[..., 1] * h
    if texel_offset is not None:
        off_x = off_x + texel_offset[0]
        off_y = off_y + texel_offset[1]
    gather = (_gather.window_gather_bilinear if use_kernel
              else _gather.window_gather_reference)
    return gather(img.contiguous(), off_y, off_x, radius=radius, row0=row0)


def band_slice(a, row0, band_h):
    """Rows [row0, row0 + band_h) of a, the band of band mode; all of a
    when row0 is None (the whole frame)."""
    return a if row0 is None else a[row0:row0 + band_h]


def screen_uv_grid(height: int, width: int, device, row0: int = 0,
                   full_height: "int | None" = None):
    """Per-pixel uv at pixel centers — the fullscreen-triangle varying
    (screen_uv in the deferred shaders). (H, W, 2). row0/full_height (band
    mode, vkr_tpu sampling.py:243-255): rows [row0, row0 + height) of a
    full_height-tall frame."""
    f32 = dict(dtype=torch.float32, device=device)
    u = (torch.arange(width, **f32) + 0.5) / width
    v = (torch.arange(row0, row0 + height, **f32) + 0.5) / (full_height
                                                           or height)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)
