"""G-buffer raster pass.

The analog of SceneRenderer::draw_taa (scene_renderer.cpp:140-215) +
gbuf/opaque_taa.{vert,frag}; vkr_tpu/passes/gbuffer.py on its static-scene
fast path. Renders the scene into
  albedo   (H, W, 4)  linear color (RGBA8_SRGB storage emulated)
  normal   (H, W, 2)  octahedral encoding in [0,1] (RG16_UNORM emulated)
  material (H, W, 4)  metallic-roughness texel (g=roughness, b=metallic)
  velocity (H, W, 2)  0.5 * (prev_ndc - cur_ndc) (RG16F emulated)
  depth    (H, W)     hardware depth (D24 emulated), 1.0 clear

Alpha-MASK materials (opaque_taa.frag:32-34 discards alpha == 0) run as a
second raster phase over the masked triangles on 8x512 tiles, alpha-tested
at resolve, with a depth-peeled second layer, then depth-merged with the
opaque phase.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vkr_tpu_torch.core.formats import (
    linear_to_srgb,
    quantize_f16,
    quantize_unorm,
    srgb_to_linear,
)
from vkr_tpu_torch.mathlib.octahedral import encode_normal
from vkr_tpu_torch.raster.pipeline import rasterize
from vkr_tpu_torch.raster.setup import corner_transform_t
from vkr_tpu_torch.raster.texture import (
    TextureArray,
    pack_texture_array,
    quad_derivative_lod,
    sample_alpha,
    sample_material_pair,
)
from vkr_tpu_torch.scene.scene import CompiledScene

DEFAULT_ALBEDO = (0.5, 0.5, 0.5, 1.0)   # opaque_taa.frag:31
DEFAULT_MATERIAL = (0.5, 0.9, 0.5, 0.5)  # opaque_taa.frag:43
MASKED_TILE_W = 512  # the masked subset is pair-starved: wide tiles


class SceneDevice(NamedTuple):
    """Device-resident scene, triangles pre-split into opaque / alpha-MASK
    subsets, with per-corner world tables built once at upload: every
    per-frame index in the raster front end is static, so the per-frame
    transform is one matmul per subset and the front end runs gather-free.
    Corner tables are component-major with corner-major columns: row j is
    component j, columns [c*T, (c+1)*T) are corner c of every triangle."""

    tri_opaque_mat: torch.Tensor   # (T1,) int32
    tri_masked_mat: torch.Tensor   # (T2,) int32
    mat_albedo_tex: torch.Tensor   # (M,) int64
    mat_mr_tex: torch.Tensor       # (M,) int64
    tex: TextureArray
    corner_world_o: torch.Tensor   # (4, 3*T1) homogeneous world position
    corner_attr_o: torch.Tensor    # (5, 3*T1) uv(2) + world normal(3)
    corner_world_m: Optional[torch.Tensor]  # (4, 3*T2); None if T2 == 0
    corner_attr_m: Optional[torch.Tensor]   # (5, 3*T2)


def _corner_tables(positions, normals, uvs, vert_transform, transforms,
                   normal_mats, tri):
    """Per-corner homogeneous world positions (4, 3T) + uv/world-normal
    corner attributes (5, 3T), component-major, corner-major columns."""
    mats = transforms[vert_transform]
    pos_h = torch.cat([positions, torch.ones_like(positions[:, :1])], -1)
    world = torch.matmul(mats, pos_h[..., None])[..., 0]
    n = torch.matmul(normal_mats[vert_transform][:, :3, :3],
                     normals[..., None])[..., 0]
    world_n = n / torch.linalg.vector_norm(n, dim=-1,
                                           keepdim=True).clamp(min=1e-20)
    vattr5 = torch.cat([uvs, world_n], -1)
    t = tri.shape[0]
    cw_t = world[tri].permute(2, 1, 0).reshape(4, 3 * t)
    at_t = vattr5[tri].permute(2, 1, 0).reshape(5, 3 * t)
    return cw_t.contiguous(), at_t.contiguous()


def upload_scene(scene: CompiledScene, device) -> SceneDevice:
    """Move a CompiledScene to `device` (the reference's staged scene
    upload, scene.cpp:270-303) and build the corner tables."""
    mask = scene.mat_clip_alpha[np.maximum(scene.tri_material, 0)] > 0
    mask &= scene.tri_material >= 0

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    geom = [dev(scene.positions), dev(scene.normals), dev(scene.uvs),
            dev(scene.vert_transform, torch.long), dev(scene.transforms),
            dev(scene.normal_mats)]
    tri_o = dev(scene.tri_indices[~mask], torch.long)
    tri_m = dev(scene.tri_indices[mask], torch.long)
    cw_o, ca_o = _corner_tables(*geom, tri_o)
    cw_m, ca_m = (_corner_tables(*geom, tri_m) if tri_m.shape[0] > 0
                  else (None, None))
    return SceneDevice(
        tri_opaque_mat=dev(scene.tri_material[~mask]),
        tri_masked_mat=dev(scene.tri_material[mask]),
        mat_albedo_tex=dev(scene.mat_albedo_tex, torch.long),
        mat_mr_tex=dev(scene.mat_mr_tex, torch.long),
        tex=pack_texture_array(scene.tex_mips, scene.tex_wrap,
                               scene.mat_albedo_tex, scene.mat_mr_tex,
                               device),
        corner_world_o=cw_o, corner_attr_o=ca_o,
        corner_world_m=cw_m, corner_attr_m=ca_m,
    )


class GBuffer(NamedTuple):
    albedo: torch.Tensor
    normal: torch.Tensor
    material: torch.Tensor
    velocity: torch.Tensor
    depth: torch.Tensor
    # () int32 — bin pairs dropped by the raster front end across all
    # phases. Nonzero means geometry silently vanished.
    overflow: torch.Tensor


def _split(resolved):
    """(10, H, W) kernel attributes -> dict of (H, W, k) channels."""
    return {
        "uv": resolved[0:2].permute(1, 2, 0),
        "normal": resolved[2:5].permute(1, 2, 0),
        "prev_clip": resolved[5:9].permute(1, 2, 0),
        "mat_id": resolved[9].to(torch.int32),
    }


def _masked_alpha(scene, attrs):
    """Sampled alpha of each pixel's masked fragment (1.0 where its
    material has no albedo texture)."""
    aidx = scene.mat_albedo_tex[attrs["mat_id"].clamp(min=0).long()]
    lod = quad_derivative_lod(attrs["uv"], scene.tex.sizes[0])
    alpha = sample_alpha(scene.tex, aidx.clamp(min=0), attrs["uv"], lod)
    return torch.where(aidx >= 0, alpha, DEFAULT_ALBEDO[3])


def _select(keep, new, old):
    return {k: torch.where(keep if k == "mat_id" else keep[..., None],
                           new[k], old[k]) for k in old}


def render_gbuffer(
    scene: SceneDevice,
    view_proj,
    prev_view_proj,
    jitter,
    *,
    width: int,
    height: int,
    quantize: bool = True,
    mask_peel_layers: int = 1,
) -> GBuffer:
    """view_proj/prev_view_proj: (4, 4) tensors; jitter: (2,) NDC offset.

    mask_peel_layers: alpha-MASK transparency layers to resolve. 1 = the
    closest masked fragment only; 2 adds a depth-peeled pass so a masked
    fragment whose alpha == 0 reveals the NEXT masked surface behind it
    (closing the gap to the reference's per-fragment discard for two
    stacked masked surfaces)."""
    dev = view_proj.device
    clip_o = corner_transform_t(scene.corner_world_o, view_proj)
    cattr_o = torch.cat([scene.corner_attr_o,
                         corner_transform_t(scene.corner_world_o,
                                            prev_view_proj)], 0)
    rkw = dict(width=width, height=height, jitter=jitter)
    vis = rasterize(clip_o, cattr_o, scene.tri_opaque_mat, **rkw)
    depth = vis.depth
    mask = vis.tri_id >= 0
    overflow = vis.overflow
    attrs = _split(vis.resolved)

    if scene.corner_world_m is not None:
        clip_m = corner_transform_t(scene.corner_world_m, view_proj)
        cattr_m = torch.cat([scene.corner_attr_m,
                             corner_transform_t(scene.corner_world_m,
                                                prev_view_proj)], 0)
        rkw_b = dict(rkw, tile_w=MASKED_TILE_W)
        vis_b = rasterize(clip_m, cattr_m, scene.tri_masked_mat,
                          keep_prepared=mask_peel_layers >= 2, **rkw_b)
        overflow = overflow + vis_b.overflow
        attrs_b = _split(vis_b.resolved)
        # Alpha test the masked layer (discard iff sampled alpha == 0,
        # opaque_taa.frag:32-34), then depth-merge with the opaque layer.
        alpha_b = _masked_alpha(scene, attrs_b)
        covered_b = vis_b.tri_id >= 0
        keep_b = covered_b & (alpha_b != 0.0) & (vis_b.depth <= depth)
        vis_depth_b = vis_b.depth
        if mask_peel_layers >= 2:
            # Where the closest masked fragment was discarded, peel to the
            # masked fragment strictly behind it and alpha-test that one:
            # K1 reruns over the same pair rows with a peel floor.
            discarded = covered_b & (alpha_b == 0.0)
            vis_b2 = rasterize(None, None, None, peel_depth=vis_b.depth,
                               prepared=vis_b, **rkw_b)
            attrs_b2 = _split(vis_b2.resolved)
            alpha_b2 = _masked_alpha(scene, attrs_b2)
            keep_b2 = (discarded & (vis_b2.tri_id >= 0)
                       & (alpha_b2 != 0.0) & (vis_b2.depth <= depth))
            vis_depth_b = torch.where(keep_b2, vis_b2.depth, vis_b.depth)
            keep_b = keep_b | keep_b2
            attrs_b = _select(keep_b2, attrs_b2, attrs_b)
        depth = torch.where(keep_b, vis_depth_b, depth)
        mask = mask | keep_b
        attrs = _select(keep_b, attrs_b, attrs)

    mat_id = torch.where(mask, attrs["mat_id"], -1)
    uv = attrs["uv"]
    m = mat_id.clamp(min=0).long()
    aidx = torch.where(mat_id >= 0, scene.mat_albedo_tex[m], -1)
    midx = torch.where(mat_id >= 0, scene.mat_mr_tex[m], -1)
    lod = quad_derivative_lod(uv, scene.tex.sizes[0])
    alb_s, mr_s = sample_material_pair(scene.tex, mat_id, uv, lod)
    f32 = dict(dtype=torch.float32, device=dev)
    albedo = torch.where((aidx >= 0)[..., None], alb_s,
                         torch.tensor(DEFAULT_ALBEDO, **f32))
    material = torch.where((midx >= 0)[..., None], mr_s,
                           torch.tensor(DEFAULT_MATERIAL, **f32))
    # SRGB textures: hardware decodes on sample (scene loads all images as
    # RGBA8_SRGB, images.cpp:22); alpha stays linear.
    albedo = torch.cat([srgb_to_linear(albedo[..., :3]), albedo[..., 3:]], -1)
    material = torch.cat([srgb_to_linear(material[..., :3]),
                          material[..., 3:]], -1)

    n = attrs["normal"]
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-20)
    normal_oct = encode_normal(n)

    prev_c = attrs["prev_clip"]
    prev_w = prev_c[..., 3:4]
    prev_ndc = prev_c[..., :2] / torch.where(prev_w.abs() < 1e-20, 1e-20,
                                             prev_w)
    # Current unjittered NDC is analytic: the raster covered this pixel with
    # jittered geometry, so interpolated pos_after == pixel ndc - jitter.
    xs = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
    ys = (torch.arange(height, **f32) + 0.5) / height * 2.0 - 1.0
    cur_ndc = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1) - jitter
    velocity = 0.5 * (prev_ndc - cur_ndc)  # opaque_taa.frag:46

    # Background: clear colors 0 (clear_color_attachments(0,0,0,0)).
    m3 = mask[..., None]
    albedo = torch.where(m3, albedo, 0.0)
    material = torch.where(m3, material, 0.0)
    normal_oct = torch.where(m3, normal_oct, 0.0)
    velocity = torch.where(m3, velocity, 0.0)

    if quantize:
        def q8(c):
            return srgb_to_linear(quantize_unorm(linear_to_srgb(c), 8))

        albedo = torch.cat([q8(albedo[..., :3]), albedo[..., 3:]], -1)
        material = torch.cat([q8(material[..., :3]), material[..., 3:]], -1)
        normal_oct = quantize_unorm(normal_oct, 16)
        velocity = quantize_f16(velocity)
        depth = quantize_unorm(depth, 24)

    return GBuffer(albedo=albedo, normal=normal_oct.contiguous(),
                   material=material, velocity=velocity.contiguous(),
                   depth=depth.contiguous(), overflow=overflow)
