"""G-buffer raster pass.

The analog of SceneRenderer::draw_taa (scene_renderer.cpp:140-215) +
gbuf/opaque_taa.{vert,frag}; vkr_tpu/passes/gbuffer.py. Renders the scene
into
  albedo   (H, W, 4)  linear color (RGBA8_SRGB storage emulated)
  normal   (H, W, 2)  octahedral encoding in [0,1] (RG16_UNORM emulated)
  material (H, W, 4)  metallic-roughness texel (g=roughness, b=metallic)
  velocity (H, W, 2)  0.5 * (prev_ndc - cur_ndc) (RG16F emulated)
  depth    (H, W)     hardware depth (D24 emulated), 1.0 clear

Alpha-MASK materials (opaque_taa.frag:32-34 discards alpha == 0) run as a
second raster phase over the masked triangles on 8x512 tiles, alpha-tested
at resolve, with a depth-peeled second layer, then depth-merged with the
opaque phase. Three front ends, as in vkr_tpu: the static-scene corner
tables (the default), the indexed per-frame gather (a scene without corner
tables), both ending in K1 with equal results, and the brute-force oracle
with the gather resolve (oracle=True, vkr_tpu's use_pallas=False).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vkr_tpu_torch.core.constants import constant
from vkr_tpu_torch.core.formats import (
    linear_to_srgb,
    quantize_f16,
    quantize_unorm,
    srgb_to_linear,
)
from vkr_tpu_torch.core.graph import span
from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.octahedral import encode_normal
from vkr_tpu_torch.raster.pipeline import rasterize
from vkr_tpu_torch.raster.resolve import (corner_attributes, interpolate_many,
                                          pixel_barycentrics)
from vkr_tpu_torch.raster.setup import (corner_table, corner_transform_t,
                                        transform_normals, transform_vertices,
                                        world_positions)
from vkr_tpu_torch.raster.texture import (
    TextureArray,
    pack_texture_array,
    pack_texture_array_native,
    quad_derivative_lod,
    quad_derivative_lod_native,
    sample_alpha,
    sample_material_pair,
    sample_texture_array,
)
from vkr_tpu_torch.scene.scene import CompiledScene

DEFAULT_ALBEDO = (0.5, 0.5, 0.5, 1.0)   # opaque_taa.frag:31
DEFAULT_MATERIAL = (0.5, 0.9, 0.5, 0.5)  # opaque_taa.frag:43
MASKED_TILE_W = 512  # the masked subset is pair-starved: wide tiles


class SceneDevice(NamedTuple):
    """Device-resident scene, triangles pre-split into opaque / alpha-MASK
    subsets. The vertex arrays feed the indexed front end. The per-corner
    world tables, built once at upload, feed the static-scene path: every
    per-frame index in the raster front end is static, so the per-frame
    transform is one matmul per subset and the front end runs gather-free.
    A scene whose corner_world_o is None takes the indexed front end.
    Corner tables are component-major with corner-major columns: row j is
    component j, columns [c*T, (c+1)*T) are corner c of every triangle."""

    positions: torch.Tensor        # (V, 3)
    normals: torch.Tensor          # (V, 3)
    uvs: torch.Tensor              # (V, 2)
    vert_transform: torch.Tensor   # (V,) int64
    transforms: torch.Tensor       # (N, 4, 4)
    normal_mats: torch.Tensor      # (N, 4, 4)
    tri_opaque: torch.Tensor       # (T1, 3) int64 vertex ids
    tri_masked: torch.Tensor       # (T2, 3) int64
    tri_opaque_mat: torch.Tensor   # (T1,) int32
    tri_masked_mat: torch.Tensor   # (T2,) int32
    mat_albedo_tex: torch.Tensor   # (M,) int64
    mat_mr_tex: torch.Tensor       # (M,) int64
    tex: TextureArray
    corner_world_o: Optional[torch.Tensor]  # (4, 3*T1) homogeneous world
    corner_attr_o: Optional[torch.Tensor]   # (5, 3*T1) uv(2) + normal(3)
    corner_world_m: Optional[torch.Tensor]  # (4, 3*T2); None if T2 == 0
    corner_attr_m: Optional[torch.Tensor]   # (5, 3*T2)


def _corner_tables(world, world_n, uvs, tri):
    """Per-corner homogeneous world positions (4, 3T) + uv/world-normal
    corner attributes (5, 3T), component-major, corner-major columns."""
    return (corner_table(world, tri).contiguous(),
            corner_table(torch.cat([uvs, world_n], -1), tri).contiguous())


def upload_scene(scene: CompiledScene, device) -> SceneDevice:
    """Move a CompiledScene to `device` (the reference's staged scene
    upload, scene.cpp:270-303), pack its textures (at their native sizes
    when the scene carries tex_images) and build the corner tables: a
    start-up span "upload" (core/graph.py)."""
    with span("upload", startup=True):
        mask = scene.mat_clip_alpha[np.maximum(scene.tri_material, 0)] > 0
        mask &= scene.tri_material >= 0

        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        positions, normals, uvs = (dev(scene.positions), dev(scene.normals),
                                   dev(scene.uvs))
        vert_transform = dev(scene.vert_transform, torch.long)
        transforms = dev(scene.transforms)
        normal_mats = dev(scene.normal_mats)
        tri_o = dev(scene.tri_indices[~mask], torch.long)
        tri_m = dev(scene.tri_indices[mask], torch.long)
        world = world_positions(positions, vert_transform, transforms)
        world_n = transform_normals(normals, vert_transform, normal_mats)
        cw_o, ca_o = _corner_tables(world, world_n, uvs, tri_o)
        cw_m, ca_m = (_corner_tables(world, world_n, uvs, tri_m)
                      if tri_m.shape[0] > 0 else (None, None))
        tex_args = (scene.tex_wrap, scene.mat_albedo_tex, scene.mat_mr_tex,
                    device)
        tex_images = getattr(scene, "tex_images", None)
        tex = (pack_texture_array_native(list(tex_images), *tex_args)
               if tex_images is not None
               else pack_texture_array(scene.tex_mips, *tex_args))
        return SceneDevice(
            positions=positions, normals=normals, uvs=uvs,
            vert_transform=vert_transform, transforms=transforms,
            normal_mats=normal_mats, tri_opaque=tri_o, tri_masked=tri_m,
            tri_opaque_mat=dev(scene.tri_material[~mask]),
            tri_masked_mat=dev(scene.tri_material[mask]),
            mat_albedo_tex=dev(scene.mat_albedo_tex, torch.long),
            mat_mr_tex=dev(scene.mat_mr_tex, torch.long),
            tex=tex,
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


def _resolve_attrs(vis, indices, tri_mat, uvs, world_n, prev_clip, *,
                   width, height, row_offset=0):
    """Per-pixel {uv, normal, prev_clip, mat_id}: K1 resolved them on the
    kernel paths; the oracle's winners are resolved by gathering their
    corner attributes and interpolating with perspective-correct
    barycentrics (resolve.py)."""
    if vis.resolved is not None:
        return _split(vis.resolved)
    bary, _ = pixel_barycentrics(vis.tri_id, vis.setup, width, height,
                                 row_offset)

    def corners(attr):
        return corner_attributes(attr, indices, vis.weights, vis.src)

    attrs = interpolate_many({"uv": corners(uvs), "normal": corners(world_n),
                              "prev_clip": corners(prev_clip)},
                             vis.tri_id, bary)
    attrs["mat_id"] = tri_mat[vis.src][vis.tri_id.clamp(min=0).long()]
    return attrs


def _lod_for(tex: TextureArray, uv, albedo_idx):
    """Mip LOD per pixel. Uniform packing: one static base size; native
    packing: the level-0 dims of each pixel's albedo texture (texture 0
    where it has none), the reference's per-texture hardware derivative
    (scene.cpp:104-161). Both material textures sample at this LOD."""
    if tex.base_size is not None:
        return quad_derivative_lod(uv, tex.base_size)
    # the texture's level-0 row (vkr_tpu's base_wh)
    row = albedo_idx.clamp(min=0) * tex.n_levels
    return quad_derivative_lod_native(
        uv, torch.stack([tex.level_w[row], tex.level_h[row]], -1))


def _masked_alpha(scene, attrs):
    """Sampled alpha of each pixel's masked fragment (1.0 where its
    material has no albedo texture)."""
    aidx = scene.mat_albedo_tex[attrs["mat_id"].clamp(min=0).long()]
    lod = _lod_for(scene.tex, attrs["uv"], aidx)
    alpha = sample_alpha(scene.tex, aidx.clamp(min=0), attrs["uv"], lod)
    return torch.where(aidx >= 0, alpha, DEFAULT_ALBEDO[3])


def _material_texture(tex, mat_tex_idx, uv, lod, default):
    """One material texture per pixel, bilinear at the rounded mip, or the
    reference's constant where the material has none (index -1): vkr_tpu's
    sampling when its set packs no albedo+MR pairs."""
    color = sample_texture_array(tex, mat_tex_idx.clamp(min=0), uv, lod)
    return torch.where((mat_tex_idx >= 0)[..., None], color,
                       constant(default, uv.device))


def _select(keep, new, old):
    return {k: torch.where(keep if k == "mat_id" else keep[..., None],
                           new[k], old[k]) for k in old}


@register("gbuf_opaque_taa")
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
    trilinear: bool = False,
    oracle: bool = False,
    full_height: "int | None" = None,
    row_offset: int = 0,
) -> GBuffer:
    """view_proj/prev_view_proj: (4, 4) tensors; jitter: (2,) NDC offset.

    full_height/row_offset: the band viewport of multi-device rendering
    (parallel/band.py, vkr_tpu gbuffer.py:248-302): rows [row_offset,
    row_offset + height) of a full_height-tall frame, bit for bit those
    rows of the full frame's G-buffer. The velocity takes the global rows;
    the texture LOD's 2x2 quads need an even row_offset.

    mask_peel_layers: alpha-MASK transparency layers to resolve. 1 = the
    closest masked fragment only; 2 adds a depth-peeled pass so a masked
    fragment whose alpha == 0 reveals the NEXT masked surface behind it
    (closing the gap to the reference's per-fragment discard for two
    stacked masked surfaces).
    trilinear: DEFAULT_SAMPLER's linear mip filter for the material
    textures (RenderConfig.trilinear_textures). As in vkr_tpu it reaches
    the pixels only when the texture set pairs each material's albedo and
    MR (TextureArray.paired); otherwise each texture is sampled bilinearly
    at the rounded mip.
    oracle: the brute-force raster and the gather resolve in place of the
    kernels (vkr_tpu's use_pallas=False): for tests and small scenes."""
    dev = view_proj.device
    fast = not oracle and scene.corner_world_o is not None
    clip = prev_clip = world_n = vattrs = None
    if not fast:
        clip, prev_clip = (
            transform_vertices(scene.positions, scene.vert_transform,
                               scene.transforms, m)
            for m in (view_proj, prev_view_proj))
        world_n = transform_normals(scene.normals, scene.vert_transform,
                                    scene.normal_mats)
        if not oracle:
            vattrs = torch.cat([scene.uvs, world_n, prev_clip], -1)

    def front(corner_world, corner_attr, tri):
        """rasterize's geometry arguments for one subset."""
        if not fast:
            return dict(clip=clip, indices=tri, vertex_attrs=vattrs,
                        oracle=oracle)
        return dict(corners_t=corner_transform_t(corner_world, view_proj),
                    corner_attrs_t=torch.cat(
                        [corner_attr,
                         corner_transform_t(corner_world, prev_view_proj)],
                        0))

    def resolve(vis, tri, tri_mat):
        return _resolve_attrs(vis, tri, tri_mat, scene.uvs, world_n,
                              prev_clip, width=width, height=height,
                              row_offset=row_offset)

    rkw = dict(width=width, height=height, jitter=jitter,
               full_height=full_height, y_offset=row_offset)
    geom_o = front(scene.corner_world_o, scene.corner_attr_o,
                   scene.tri_opaque)
    vis = rasterize(tri_mat=scene.tri_opaque_mat, **geom_o, **rkw)
    depth = vis.depth
    mask = vis.tri_id >= 0
    overflow = vis.overflow
    attrs = resolve(vis, scene.tri_opaque, scene.tri_opaque_mat)

    if scene.tri_masked.shape[0] > 0:
        geom_m = front(scene.corner_world_m, scene.corner_attr_m,
                       scene.tri_masked)
        rkw_b = dict(rkw, tile_w=MASKED_TILE_W)
        peel_rerun = not oracle and mask_peel_layers >= 2
        vis_b = rasterize(tri_mat=scene.tri_masked_mat,
                          keep_prepared=peel_rerun, **geom_m, **rkw_b)
        overflow = overflow + vis_b.overflow
        attrs_b = resolve(vis_b, scene.tri_masked, scene.tri_masked_mat)
        # Alpha test the masked layer (discard iff sampled alpha == 0,
        # opaque_taa.frag:32-34), then depth-merge with the opaque layer.
        alpha_b = _masked_alpha(scene, attrs_b)
        covered_b = vis_b.tri_id >= 0
        keep_b = covered_b & (alpha_b != 0.0) & (vis_b.depth <= depth)
        vis_depth_b = vis_b.depth
        if mask_peel_layers >= 2:
            # Where the closest masked fragment was discarded, peel to the
            # masked fragment strictly behind it and alpha-test that one:
            # K1 reruns over the same pair rows with a peel floor (the
            # oracle reruns whole).
            discarded = covered_b & (alpha_b == 0.0)
            if peel_rerun:
                vis_b2 = rasterize(peel_depth=vis_b.depth, prepared=vis_b,
                                   **rkw_b)
            else:
                vis_b2 = rasterize(tri_mat=scene.tri_masked_mat,
                                   peel_depth=vis_b.depth, **geom_m, **rkw_b)
            attrs_b2 = resolve(vis_b2, scene.tri_masked, scene.tri_masked_mat)
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
    lod = _lod_for(scene.tex, uv, aidx)
    f32 = dict(dtype=torch.float32, device=dev)
    if scene.tex.paired:
        alb_s, mr_s = sample_material_pair(scene.tex, mat_id, uv, lod,
                                           trilinear=trilinear)
        albedo = torch.where((aidx >= 0)[..., None], alb_s,
                             constant(DEFAULT_ALBEDO, dev))
        material = torch.where((midx >= 0)[..., None], mr_s,
                               constant(DEFAULT_MATERIAL, dev))
    else:
        albedo = _material_texture(scene.tex, aidx, uv, lod, DEFAULT_ALBEDO)
        material = _material_texture(scene.tex, midx, uv, lod,
                                     DEFAULT_MATERIAL)
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
    ys = (torch.arange(row_offset, row_offset + height, **f32) + 0.5) \
        / (full_height or height) * 2.0 - 1.0
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


@register("gbuf_opaque")
def render_gbuffer_legacy(scene: SceneDevice, view_proj, *, width: int,
                          height: int, quantize: bool = True,
                          trilinear: bool = False,
                          oracle: bool = False) -> GBuffer:
    """The non-TAA G-buffer (gbuf/opaque.{vert,frag}; manifest entry
    gbuf_opaque): the unjittered raster with no motion vectors. As in
    vkr_tpu (gbuffer.py:506): the TAA raster with zero jitter and
    prev == cur projection, its velocity plane (which the legacy pass does
    not produce) set to zero."""
    gbuf = render_gbuffer(
        scene, view_proj, view_proj,
        torch.zeros(2, dtype=torch.float32, device=view_proj.device),
        width=width, height=height, quantize=quantize, trilinear=trilinear,
        oracle=oracle)
    return gbuf._replace(velocity=torch.zeros_like(gbuf.velocity))
