"""Deferred PBR shading pass.

Same math as the reference's defered_shading/shader.frag and
vkr_tpu/passes/shading.py: one hard-coded point light with GGX specular
(alpha-parameterized NDF + height-correlated Smith G2) + Lambert diffuse +
0.6 ambient, SSR reflections applied through the split-sum BRDF LUT, and
AO/reflections fetched from half-res with the 4-tap nearest-depth upsample
(sample_ocllusion_ssr, shader.frag:104-129).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkr_ref.core.constants import constant
from vkr_ref.core.registry import register
from vkr_ref.mathlib.brdf import (
    PI,
    brdf_g2,
    distribution_ggx,
    f0_approximation,
    fresnel_schlick,
)
from vkr_ref.mathlib.octahedral import decode_normal
from vkr_ref.mathlib.projection import reconstruct_view_vec
from vkr_ref.passes.sampling import (
    band_slice,
    bilinear_from_quad,
    quad_pack,
    screen_uv_grid,
    upsample_half_bilinear,
)

LIGHT_POS = (-1.85867, 5.81832, -0.247114)   # shader.frag:36
LIGHT_RADIANCE = (0.1, 0.1, 0.1)             # shader.frag:37


class ShadingParams(NamedTuple):
    inverse_camera: torch.Tensor  # (4,4) view -> world
    fovy: float
    aspect: float
    znear: float
    zfar: float
    min_roughness: float = 0.0   # defered_shading.hpp:30
    max_roughness: float = 1.0
    show_ao: bool = False


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def sample_occlusion_ssr(depth_full, depth_half, occlusion, reflections,
                         row0: "int | None" = None):
    """Depth-aware 4-tap half-res upsample (shader.frag:104-129): pick the
    half-res texel (of 4 neighbors) whose depth best matches full-res; the
    first of equal candidates wins. The taps are regular-grid, so they run
    as dense 2x upsampling.

    row0 (band mode, full-res rows, even; vkr_tpu shading.py:45):
    depth_full covers only the band; the half-res inputs stay whole and are
    cut to the band with a 2-row halo, so the upsample's phases and edge
    clamps are the full frame's."""
    if row0 is None:
        def cut(a):
            return a
    else:
        bhf = depth_full.shape[0]
        h = depth_half.shape[0]

        def half_halo(a):
            # half-res rows [row0/2 - 2, row0/2 + bhf/2 + 2), the frame's
            # edges replicated
            idx = (torch.arange(row0 // 2 - 2, row0 // 2 + bhf // 2 + 2,
                                device=a.device)).clamp(0, h - 1)
            return a.index_select(0, idx)

        depth_half, occlusion, reflections = (
            half_halo(a) for a in (depth_half, occlusion, reflections))

        def cut(a):
            # upsampled rows [4, 4 + bhf) are the band
            return a[4:4 + bhf]
    best_delta = best_occ = best_refl = None
    for off in ((0, 0), (1, 0), (0, 1), (1, 1)):
        delta = (cut(upsample_half_bilinear(depth_half, off))
                 - depth_full).abs()
        occ = cut(upsample_half_bilinear(occlusion, off))
        refl = cut(upsample_half_bilinear(reflections, off))
        if best_delta is None:
            best_delta, best_occ, best_refl = delta, occ, refl
            continue
        # strictly smaller: ties keep the earlier tap (argmin semantics)
        better = delta < best_delta
        best_delta = torch.where(better, delta, best_delta)
        best_occ = torch.where(better, occ, best_occ)
        best_refl = torch.where(better[..., None], refl, best_refl)
    return best_occ, best_refl


@register("defered_shading")
def deferred_shading(gbuffer, params: ShadingParams, occlusion, reflections,
                     brdf_lut, depth_half, row0: "int | None" = None,
                     band_h: "int | None" = None):
    """gbuffer: GBuffer; occlusion (H/2, W/2); reflections (H/2, W/2, 3);
    brdf_lut (S, S, 2); depth_half (H/2, W/2). Returns (H, W, 3).
    row0/band_h (band mode, full-res rows, even; vkr_tpu shading.py:103):
    the rows [row0, row0 + band_h) from the whole G-buffer."""
    H, w = gbuffer.depth.shape
    h = H if row0 is None else band_h
    uv = screen_uv_grid(h, w, gbuffer.depth.device, row0=row0 or 0,
                        full_height=H)
    normal_oct, albedo, material, depth = (
        band_slice(a, row0, h) for a in (gbuffer.normal, gbuffer.albedo,
                                         gbuffer.material, gbuffer.depth))
    normal = decode_normal(normal_oct)
    albedo = albedo[..., :3]

    occ, refl = sample_occlusion_ssr(depth, depth_half, occlusion,
                                     reflections, row0)

    view_vec = reconstruct_view_vec(uv, depth, params.fovy, params.aspect,
                                    params.znear, params.zfar)
    inv_cam = params.inverse_camera
    world_pos = view_vec @ inv_cam[:3, :3].T + inv_cam[:3, 3]
    camera_pos = inv_cam[:3, 3]

    metallic = 0.1 + 0.9 * material[..., 2]   # mix(0.1, 1.0, material.b)
    roughness = material[..., 1]

    v = camera_pos - world_pos
    v = v / _norm(v, True).clamp(min=1e-20)
    n = normal

    f0 = f0_approximation(albedo, metallic)

    light_pos = constant(LIGHT_POS, depth.device)
    to_light = light_pos - world_pos
    light_dist = _norm(to_light)
    l = to_light / light_dist[..., None].clamp(min=1e-20)
    hvec = v + l
    hvec = hvec / _norm(hvec, True).clamp(min=1e-20)

    radiance = constant(LIGHT_RADIANCE, depth.device) * (
        torch.clamp(100.0 / (light_dist * light_dist), max=100.0)[..., None]
    )

    ndl = torch.clamp((n * l).sum(-1), min=0.0)
    ndv = torch.clamp((n * v).sum(-1), min=0.0)
    ndh = (n * hvec).sum(-1)
    hdv = torch.clamp((hvec * v).sum(-1), min=0.0)

    ndf = distribution_ggx(ndh, roughness)
    g = brdf_g2(ndv, ndl, roughness * roughness)
    f = fresnel_schlick(hdv, f0)

    ks = f
    kd = (1.0 - ks) * (1.0 - metallic)[..., None]
    specular = (ndf * g)[..., None] * f / (4.0 * ndv * ndl + 1e-4)[..., None]

    lo = (kd * albedo / PI + specular) * radiance * ndl[..., None]

    biased_roughness = (params.min_roughness
                        + (params.max_roughness - params.min_roughness)
                        * roughness)
    lut_uv = torch.stack([biased_roughness, ndv], dim=-1)
    ssr_brdf = bilinear_from_quad(quad_pack(brdf_lut), 2, lut_uv)
    lo = lo + refl * (f0 * ssr_brdf[..., 0:1] + ssr_brdf[..., 1:2])

    if params.show_ao:
        return occ[..., None].expand(-1, -1, 3)
    return occ[..., None] * (0.6 * albedo + lo)
