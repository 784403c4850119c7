"""Texture array sampling — the bindless-descriptor analog.

The reference binds all scene textures as one variable-count descriptor
array (set 1 `sampler2D material_textures[]`, scene_renderer.cpp:84-103)
and samples with per-fragment indices. Here all textures live in one flat
uint8 tensor holding each texture's packed mip chain, and per (texture,
level) columns of texel offset, width and height locate each level:
sampling is per-pixel texture index, mip level and the texture's wrap mode
(DEFAULT_SAMPLER linear filter, samplers.hpp:36-50; glTF samplers' wrap,
scene.cpp:104-161). Two packings fill it, as in vkr_tpu: uniform (every
texture resized to one square size, mips down to 1x1) and native (each
texture at its own size and aspect, odd edges padded before halving, the
levels past a texture's chain repeating its 1x1 tail). Both are built once
at upload, so sampling makes no host-to-device copy.

vkr_tpu packs each texel's 2x2 bilinear footprint into quad rows (and
albedo+MR pairs into 32-byte rows) because its TPU gather is priced per
index. The port fetches the four texels directly; the values are the same:
repeat wraps both taps, clamp clamps both (vkr_tpu's zero weight at the low
clamp edge selects the same texel). It keeps vkr_tpu's pairing DECISION,
which changes pixels: trilinear filtering reaches the G-buffer only through
vkr_tpu's pair path (TextureArray.paired).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vkr_ref.scene.gltf import WRAP_CLAMP, WRAP_REPEAT

QUALITIES = ("trilinear", "bilinear", "nearest")


@dataclasses.dataclass
class TextureArray:
    """Device texture set. Level row t * n_levels + l is texture t's level
    l: its texel offset, width and height, one contiguous column each, so
    a per-pixel lookup reads only the columns it needs."""

    texels: torch.Tensor     # (N, 4) uint8 — every texture's mips, packed
    level_off: torch.Tensor  # (NT * L,) int64 texel offset of each level
    level_w: torch.Tensor    # (NT * L,) int32 width of each level
    level_h: torch.Tensor    # (NT * L,) int32 height of each level
    wrap: torch.Tensor       # (NT,) int32 WRAP_* per texture
    n_levels: int            # L: levels of the longest chain
    # uniform packing: the level-0 edge (the LOD's one static scale);
    # None for the native packing, whose LOD scales per pixel
    base_size: Optional[int]
    # vkr_tpu packs albedo+MR pair rows for this set (its pair path, the
    # only one that filters trilinearly; see _pairs_uniform/_pairs_native)
    paired: bool
    mat_albedo_tex: torch.Tensor  # (M,) int64 albedo texture per material
    mat_mr_tex: torch.Tensor      # (M,) int64 metallic-roughness texture


def _wrap_list(wrap, nt):
    w = np.zeros(nt, np.int64)
    w[:min(len(wrap), nt)] = np.asarray(wrap, np.int64)[:nt]
    return w


def _pairs_uniform(wrap_np, at, mt) -> bool:
    """vkr_tpu's uniform pairing (texture.py:164-169): every material's
    albedo and MR wraps agree, and some material has a texture."""
    if any(a >= 0 and b >= 0 and wrap_np[a] != wrap_np[b]
           for a, b in zip(at, mt)):
        return False
    return any(a >= 0 or b >= 0 for a, b in zip(at, mt))


def _pairs_native(images, wrap_np, at, mt) -> bool:
    """vkr_tpu's native pairing (texture.py:334-358), all or nothing:
    every material's two textures agree in wrap and dims."""
    any_pair = False
    for a, b in zip(at, mt):
        if a < 0 and b < 0:
            continue
        if a >= 0 and b >= 0 and (
                wrap_np[a] != wrap_np[b]
                or images[a].shape[:2] != images[b].shape[:2]):
            return False
        any_pair = True
    return any_pair


def _device_set(texels, meta, wrap_np, n_levels, base_size,
                paired, mat_albedo_tex, mat_mr_tex, device) -> TextureArray:
    """meta: (NT * L, 3) [offset, w, h] per level row."""
    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return TextureArray(
        texels=dev(texels, np.uint8), level_off=dev(meta[:, 0], np.int64),
        level_w=dev(meta[:, 1], np.int32), level_h=dev(meta[:, 2], np.int32),
        wrap=dev(wrap_np, np.int32),
        n_levels=int(n_levels), base_size=base_size, paired=bool(paired),
        mat_albedo_tex=dev(mat_albedo_tex, np.int64),
        mat_mr_tex=dev(mat_mr_tex, np.int64))


def pack_texture_array(tex_mips, wrap, mat_albedo_tex, mat_mr_tex,
                       device) -> TextureArray:
    """Uniform packing: (mip pyramids from scene.build_mip_pyramid) ->
    device TextureArray. Texture t's level l starts at t * FLAT + the
    level's offset, FLAT = sum of the levels' texel counts."""
    sizes = [int(m.shape[1]) for m in tex_mips]
    offsets = np.cumsum([0] + [s * s for s in sizes])
    flat_len = int(offsets[-1])
    nt = tex_mips[0].shape[0]
    flat = np.concatenate(
        [np.asarray(m, np.uint8).reshape(nt, -1, 4) for m in tex_mips], axis=1)
    wrap_np = _wrap_list(wrap, nt)
    t, lev = np.meshgrid(np.arange(nt), np.arange(len(sizes)), indexing="ij")
    size = np.asarray(sizes)[lev]
    meta = np.stack([t * flat_len + offsets[lev], size, size],
                    -1).reshape(-1, 3)
    at, mt = np.asarray(mat_albedo_tex), np.asarray(mat_mr_tex)
    return _device_set(flat.reshape(-1, 4), meta, wrap_np, len(sizes),
                       sizes[0], _pairs_uniform(wrap_np, at, mt),
                       at, mt, device)


def _mip_chain_native(img):
    """Per-texture mip chain at native aspect: 2x2 box filter with
    round-half-up halving each edge (an odd edge is padded with its last
    row or column first) down to 1x1."""
    mips = [np.asarray(img, np.uint8)]
    cur = mips[0]
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h & 1:
            cur = np.concatenate([cur, cur[-1:]], axis=0)
            h += 1
        if w & 1:
            cur = np.concatenate([cur, cur[:, -1:]], axis=1)
            w += 1
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        cur = ((cur.astype(np.uint16).reshape(h2, 2, w2, 2, 4)
                .sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)
        mips.append(cur)
    return mips


def pack_texture_array_native(images, wrap, mat_albedo_tex, mat_mr_tex,
                              device) -> TextureArray:
    """Native packing: images (list of (h, w, 4) u8 at their own sizes,
    scene.compile_scene(native_sizes=True)) -> device TextureArray. The
    chains pack texture by texture, level by level; levels past a chain's
    end repeat its 1x1 tail's meta row, so per-pixel level clamps are free
    (vkr_tpu texture.py:281-394)."""
    nt = len(images)
    wrap_np = _wrap_list(wrap, nt)
    chains = [_mip_chain_native(im) for im in images]
    n_levels = max(len(c) for c in chains)
    meta = np.zeros((nt * n_levels, 3), np.int64)
    parts = []
    off = 0
    for t, chain in enumerate(chains):
        for lev in range(n_levels):
            row = t * n_levels + lev
            if lev < len(chain):
                h, w = chain[lev].shape[:2]
                meta[row] = (off, w, h)
                parts.append(chain[lev].reshape(-1, 4))
                off += h * w
            else:
                meta[row] = meta[row - 1]
    at, mt = np.asarray(mat_albedo_tex), np.asarray(mat_mr_tex)
    return _device_set(np.concatenate(parts), meta, wrap_np, n_levels, None,
                       _pairs_native(images, wrap_np, at, mt), at, mt,
                       device)


_RHO_MIN = torch.tensor(1e-12)  # a CPU scalar: no copy to the card


def quad_derivative_lod(uv, base_size: int):
    """Hardware-style 2x2 quad derivatives -> mip LOD per pixel.

    Both pixels of a quad pair share the same finite difference, as on a
    GPU. uv: (H, W, 2) in texture uv units (H, W even). Returns (H, W)."""
    return _lod(uv, float(base_size))


def quad_derivative_lod_native(uv, wh):
    """quad_derivative_lod with PER-PIXEL texture dims (native packing):
    wh (H, W, 2) int, the level-0 (width, height) of each pixel's
    texture."""
    return _lod(uv, wh.to(torch.float32))


def _lod(uv, scale):
    h, w, _ = uv.shape
    uv_x = uv.reshape(h, w // 2, 2, 2)
    dx = (uv_x[:, :, 1] - uv_x[:, :, 0]).repeat_interleave(2, dim=1)
    uv_y = uv.reshape(h // 2, 2, w, 2)
    dy = (uv_y[:, 1] - uv_y[:, 0]).repeat_interleave(2, dim=0)
    rho = torch.maximum(
        torch.linalg.vector_norm(dx * scale, dim=-1),
        torch.linalg.vector_norm(dy * scale, dim=-1),
    )
    # fmax, not clamp: a NaN rho (a NaN uv of the oracle resolve) gives the
    # lowest LOD, so level 0, as XLA's NaN-to-0 cast gives vkr_tpu, and not
    # a NaN level that the CPU would cast to an out-of-bounds index
    return torch.log2(torch.fmax(rho, _RHO_MIN))


def _wrap_coord(i, size, repeat):
    return torch.where(repeat, torch.remainder(i, size),
                       torch.minimum(i.clamp(min=0), size - 1))


def _dims(tex: TextureArray, row):
    """Per-pixel (width, height) int32 of level rows `row`; the uniform
    packing's levels are square, so its height is its width."""
    w = tex.level_w[row]
    return w, (w if tex.base_size is not None else tex.level_h[row])


def _taps(tex: TextureArray, tex_idx, uv, level):
    """Bilinear taps of texture tex_idx (>= 0) at a per-pixel level: the
    level's texel offset (int64), the four texel indices relative to it
    (t00, t10, t01, t11; int32) and the weights (fx, fy). In int32, as
    vkr_tpu computes them (_tap_setup_native)."""
    row = tex_idx * tex.n_levels + level
    w, h = _dims(tex, row)
    wrap = tex.wrap[tex_idx]
    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    # Clamp mode collapses both taps onto texel 0 at the low edge.
    clamp = wrap == WRAP_CLAMP
    fx = torch.where(clamp & (x0 < 0), 0.0, fx)
    fy = torch.where(clamp & (y0 < 0), 0.0, fy)
    repeat = wrap == WRAP_REPEAT
    xa, xb = _wrap_coord(x0, w, repeat), _wrap_coord(x0 + 1, w, repeat)
    ra = _wrap_coord(y0, h, repeat) * w
    rb = _wrap_coord(y0 + 1, h, repeat) * w
    return (tex.level_off[row], (ra + xa, ra + xb, rb + xa, rb + xb), fx,
            fy)


def _bilerp(t00, t10, t01, t11, fx, fy):
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def _level(tex: TextureArray, lod):
    """Bilinear-at-rounded-mip level: round(clip(lod)), half to even."""
    return torch.round(lod.clamp(0.0, tex.n_levels - 1)).long()


def _fetch(tex: TextureArray, off, rel, fx, fy):
    """The bilinear value of the four texels off + rel: (H, W, 4) f32 raw
    [0, 1] values."""
    t = [tex.texels[off + r].float() / 255.0 for r in rel]
    return _bilerp(*t, fx[..., None], fy[..., None])


def _sample_level(tex: TextureArray, tex_idx, uv, level):
    """Bilinear tap of texture tex_idx (>= 0) at a per-pixel mip level."""
    off, rel, fx, fy = _taps(tex, tex_idx, uv, level)
    return _fetch(tex, off, rel, fx, fy)


def _sample_level_nearest(tex: TextureArray, tex_idx, uv, level):
    row = tex_idx * tex.n_levels + level
    w, h = _dims(tex, row)
    repeat = tex.wrap[tex_idx] == WRAP_REPEAT
    xi = _wrap_coord(torch.floor(uv[..., 0] * w.to(torch.float32)).to(
        torch.int32), w, repeat)
    yi = _wrap_coord(torch.floor(uv[..., 1] * h.to(torch.float32)).to(
        torch.int32), h, repeat)
    return tex.texels[tex.level_off[row] + (yi * w + xi)].float() / 255.0


def _trilinear(fetch, lod, n_levels):
    """Linear mip filter between floor(lod) and the next level."""
    l0 = torch.floor(lod).long()
    l1 = (l0 + 1).clamp(max=n_levels - 1)
    frac = (lod - l0.to(torch.float32))[..., None]
    c0, c1 = fetch(l0), fetch(l1)
    if isinstance(c0, tuple):
        return tuple(a + (b - a) * frac for a, b in zip(c0, c1))
    return c0 + (c1 - c0) * frac


def sample_texture_array(tex: TextureArray, tex_idx, uv, lod=None,
                         quality: str = "bilinear"):
    """Mipmapped sample of texture tex_idx (H, W) int >= 0 at uv (H, W, 2).

    quality: 'trilinear' (linear mip filter, DEFAULT_SAMPLER parity),
    'bilinear' (bilinear at the rounded mip; the default) or 'nearest'
    (one texel at the rounded mip). lod None samples level 0 bilinearly.
    Returns (H, W, 4) f32 raw [0, 1] values (sRGB decode is the caller's)."""
    if quality not in QUALITIES:
        raise ValueError(f"quality {quality!r} is not one of {QUALITIES}")
    if lod is None:
        return _sample_level(tex, tex_idx, uv, torch.zeros_like(tex_idx))
    lod = lod.clamp(0.0, tex.n_levels - 1)
    if quality == "trilinear":
        return _trilinear(lambda lev: _sample_level(tex, tex_idx, uv, lev),
                          lod, tex.n_levels)
    level = torch.round(lod).long()
    if quality == "nearest":
        return _sample_level_nearest(tex, tex_idx, uv, level)
    return _sample_level(tex, tex_idx, uv, level)


def sample_alpha(tex: TextureArray, tex_idx, uv, lod):
    """Bilinear ALPHA tap at the rounded mip for the alpha-MASK discard
    test (opaque_taa.frag:32-34). Interpolates the raw 0..255 values and
    divides by 255 last, as vkr_tpu's sample_alpha_sparse does (on its
    active tiles, in both its branches). tex_idx (H, W) int >= 0.
    Returns (H, W) f32."""
    off, rel, fx, fy = _taps(tex, tex_idx, uv, _level(tex, lod))
    a = [tex.texels[off + r, 3].float() for r in rel]
    return _bilerp(*a, fx, fy) / 255.0


def sample_material_pair(tex: TextureArray, mat_id, uv, lod,
                         trilinear: bool = False):
    """Both material textures of each pixel at one LOD (vkr_tpu's pair
    path): (albedo (H,W,4), metallic-roughness (H,W,4)) raw [0,1] values,
    bilinear at the rounded mip, or filtered between mips with trilinear.
    The caller masks halves whose texture is absent (index -1).

    Needs a paired set (TextureArray.paired): a material's two textures
    then agree in wrap and in every level's dims, so one tap setup serves
    both, as vkr_tpu's one pair-row gather does. It follows the albedo
    texture, or the MR texture where the material has no albedo."""
    if not tex.paired:
        raise ValueError("sample_material_pair needs a set that pairs each "
                         "material's albedo and MR (TextureArray.paired)")
    m = mat_id.clamp(min=0)
    a = tex.mat_albedo_tex[m]
    b = tex.mat_mr_tex[m]
    ai = torch.where(a >= 0, a, b).clamp(min=0)
    mi = torch.where(b >= 0, b, ai)
    lod = lod.clamp(0.0, tex.n_levels - 1)

    def fetch(level):
        off, rel, fx, fy = _taps(tex, ai, uv, level)
        off_mr = tex.level_off[mi * tex.n_levels + level]
        return (_fetch(tex, off, rel, fx, fy),
                _fetch(tex, off_mr, rel, fx, fy))

    if trilinear:
        return _trilinear(fetch, lod, tex.n_levels)
    return fetch(torch.round(lod).long())
