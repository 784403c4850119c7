"""Texture array sampling — the bindless-descriptor analog.

The reference binds all scene textures as one variable-count descriptor
array (set 1 `sampler2D material_textures[]`, scene_renderer.cpp:84-103)
and samples with per-fragment indices. Here all textures live in one flat
uint8 tensor holding each texture's packed mip pyramid (uniform size);
sampling is per-pixel texture index, mip level and per-texture wrap mode
(DEFAULT_SAMPLER linear filter, samplers.hpp:36-50; glTF samplers' wrap,
scene.cpp:104-161).

vkr_tpu packs each texel's 2x2 bilinear footprint into quad rows (and
albedo+MR pairs into 32-byte rows) because its TPU gather is priced per
index. The port fetches the four texels directly; the values are the same:
repeat wraps both taps, clamp clamps both (vkr_tpu's zero weight at the low
clamp edge selects the same texel).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vkr_tpu_torch.scene.gltf import WRAP_CLAMP, WRAP_REPEAT


@dataclasses.dataclass
class TextureArray:
    """Device texture set (uniform size). The mip layout (offsets/sizes/
    flat_len) is static Python metadata."""

    texels: torch.Tensor     # (NT * FLAT, 4) uint8 — all textures, mips packed
    wrap: torch.Tensor       # (NT,) int64 WRAP_* per texture
    offsets: Tuple[int, ...]  # texel offset of each mip level
    sizes: Tuple[int, ...]    # edge length of each mip level
    flat_len: int             # FLAT = sum(sizes^2)
    mat_albedo_tex: torch.Tensor  # (M,) int64 albedo texture per material
    mat_mr_tex: torch.Tensor      # (M,) int64 metallic-roughness texture

    @property
    def n_levels(self) -> int:
        return len(self.sizes)


def pack_texture_array(tex_mips, wrap, mat_albedo_tex, mat_mr_tex,
                       device) -> TextureArray:
    """(mip pyramids from scene.build_mip_pyramid) -> device TextureArray."""
    sizes = tuple(int(m.shape[1]) for m in tex_mips)
    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s * s
    nt = tex_mips[0].shape[0]
    flat = np.concatenate(
        [np.asarray(m, np.uint8).reshape(nt, -1, 4) for m in tex_mips], axis=1)
    wrap_np = np.zeros(nt, np.int64)
    wrap_np[:len(wrap)] = np.asarray(wrap)[:nt]
    return TextureArray(
        texels=torch.from_numpy(flat.reshape(-1, 4)).to(device),
        wrap=torch.from_numpy(wrap_np).to(device),
        offsets=tuple(offsets), sizes=sizes, flat_len=off,
        mat_albedo_tex=torch.as_tensor(
            np.asarray(mat_albedo_tex, np.int64), device=device),
        mat_mr_tex=torch.as_tensor(
            np.asarray(mat_mr_tex, np.int64), device=device),
    )


def quad_derivative_lod(uv, base_size: int):
    """Hardware-style 2x2 quad derivatives -> mip LOD per pixel.

    Both pixels of a quad pair share the same finite difference, as on a
    GPU. uv: (H, W, 2) in texture uv units (H, W even). Returns (H, W)."""
    h, w, _ = uv.shape
    uv_x = uv.reshape(h, w // 2, 2, 2)
    dx = (uv_x[:, :, 1] - uv_x[:, :, 0]).repeat_interleave(2, dim=1)
    uv_y = uv.reshape(h // 2, 2, w, 2)
    dy = (uv_y[:, 1] - uv_y[:, 0]).repeat_interleave(2, dim=0)
    scale = float(base_size)
    rho = torch.maximum(
        torch.linalg.vector_norm(dx * scale, dim=-1),
        torch.linalg.vector_norm(dy * scale, dim=-1),
    )
    return torch.log2(rho.clamp(min=1e-12))


def _level(tex: TextureArray, lod):
    """Bilinear-at-rounded-mip level: round(clip(lod)), half to even."""
    return torch.round(lod.clamp(0.0, tex.n_levels - 1)).long()


def _wrap_coord(i, size, wrap_mode):
    return torch.where(wrap_mode == WRAP_REPEAT, torch.remainder(i, size),
                       torch.minimum(i.clamp(min=0), size - 1))


def _taps(tex: TextureArray, tex_idx, uv, level):
    """The four texel row indices (t00, t10, t01, t11) and the bilinear
    weights (fx, fy) of each pixel's sample of texture tex_idx."""
    dev = uv.device
    s = torch.tensor(tex.sizes, device=dev)[level]
    o = torch.tensor(tex.offsets, device=dev)[level]
    wrap_mode = tex.wrap[tex_idx]
    sf = s.float()
    x = uv[..., 0] * sf - 0.5
    y = uv[..., 1] * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    # Clamp mode collapses both taps onto texel 0 at the low edge.
    clamp = wrap_mode == WRAP_CLAMP
    fx = torch.where(clamp & (x0 < 0), 0.0, fx)
    fy = torch.where(clamp & (y0 < 0), 0.0, fy)
    xa, xb = _wrap_coord(x0, s, wrap_mode), _wrap_coord(x0 + 1, s, wrap_mode)
    ya, yb = _wrap_coord(y0, s, wrap_mode), _wrap_coord(y0 + 1, s, wrap_mode)
    base = tex_idx * tex.flat_len + o
    return (base + ya * s + xa, base + ya * s + xb,
            base + yb * s + xa, base + yb * s + xb), fx, fy


def _bilerp(t00, t10, t01, t11, fx, fy):
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_alpha(tex: TextureArray, tex_idx, uv, lod):
    """Bilinear ALPHA tap at the rounded mip for the alpha-MASK discard
    test (opaque_taa.frag:32-34). Interpolates the raw 0..255 values and
    divides by 255 last, as vkr_tpu's sample_alpha_sparse does.
    tex_idx (H, W) int >= 0. Returns (H, W) f32."""
    idx, fx, fy = _taps(tex, tex_idx, uv, _level(tex, lod))
    a = [tex.texels[i, 3].float() for i in idx]
    return _bilerp(*a, fx, fy) / 255.0


def sample_texture(tex: TextureArray, tex_idx, uv, level):
    """Bilinear tap of texture tex_idx at a per-pixel mip level:
    (H, W, 4) f32 raw [0, 1] values."""
    idx, fx, fy = _taps(tex, tex_idx, uv, level)
    t = [tex.texels[i].float() / 255.0 for i in idx]
    return _bilerp(*t, fx[..., None], fy[..., None])


def sample_material_pair(tex: TextureArray, mat_id, uv, lod):
    """Both material textures of each pixel, bilinear at the rounded mip:
    (albedo (H,W,4), metallic-roughness (H,W,4)) raw [0,1] values. The
    caller masks halves whose texture is absent (index -1)."""
    level = _level(tex, lod)
    m = mat_id.clamp(min=0)
    albedo = sample_texture(tex, tex.mat_albedo_tex[m].clamp(min=0), uv,
                            level)
    mr = sample_texture(tex, tex.mat_mr_tex[m].clamp(min=0), uv, level)
    return albedo, mr
