"""Shadow-map render path + shadow-factor sampling.

The reference carries a complete (but disabled) shadow pipeline: a
depth-only raster from the light's view — SceneRenderer::render_shadow
(scene_renderer.cpp:222-260) with the 'default_shadow' program
(shaders/shadows/default.vert: gl_Position = shadow_mvp * model * pos,
empty fragment). vkr_tpu/passes/shadows.py provides it as an optional
pass, off by default like the reference; this is its port.

The depth-only raster is the visibility rasterizer without attributes:
raster/pipeline.rasterize with no corner attributes, which runs K7
(raster/kernel.rasterize_tiles). The shadow test is a depth compare
against the light-space reprojection with a constant bias.
"""

from __future__ import annotations

import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.passes.gbuffer import SceneDevice
from vkr_tpu_torch.raster.pipeline import rasterize
from vkr_tpu_torch.raster.setup import corner_transform_t


def scene_corners(scene: SceneDevice):
    """(4, 3T) world corner table of the whole scene, opaque triangles
    before masked ones in each corner block, so triangle i is vkr_tpu's
    concatenate([tri_opaque, tri_masked])[i]."""
    if scene.corner_world_m is None:
        return scene.corner_world_o
    t_o = scene.corner_world_o.shape[1] // 3
    t_m = scene.corner_world_m.shape[1] // 3
    blocks = []
    for c in range(3):
        blocks.append(scene.corner_world_o[:, c * t_o:(c + 1) * t_o])
        blocks.append(scene.corner_world_m[:, c * t_m:(c + 1) * t_m])
    return torch.cat(blocks, dim=1)


@register("default_shadow")
def render_shadow_map(scene: SceneDevice, shadow_mvp, size: int = 1024):
    """Depth-only raster of the whole scene from the light
    (render_shadow / shaders/shadows/default.vert). shadow_mvp: (4, 4)
    tensor on the scene's device. Returns (size, size) f32 hardware depth,
    1.0 clear."""
    clip = corner_transform_t(scene_corners(scene), shadow_mvp)
    return rasterize(clip, width=size, height=size).depth


def sample_shadow_factor(world_pos, shadow_mvp, shadow_map,
                         bias: float = 2e-3):
    """1.0 where lit, 0.0 where occluded: project world positions into
    the light's clip space and depth-compare against the shadow map
    (nearest tap).

    world_pos: (H, W, 3); shadow_map: (S, S) from render_shadow_map."""
    m = shadow_mvp
    s = shadow_map.shape[0]
    ph = world_pos @ m[:3, :3].T + m[:3, 3]
    w = (world_pos @ m[3, :3][:, None] + m[3, 3])[..., 0]
    w = torch.where(w.abs() < 1e-20, 1e-20, w)
    ndc = ph / w[..., None]
    uv = ndc[..., :2] * 0.5 + 0.5
    xi = (uv[..., 0] * s).to(torch.int32).clamp(0, s - 1).long()
    yi = (uv[..., 1] * s).to(torch.int32).clamp(0, s - 1).long()
    occluder = shadow_map.reshape(-1)[yi * s + xi]
    in_frustum = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
                  & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0)
                  & (ndc[..., 2] >= 0.0) & (ndc[..., 2] <= 1.0) & (w > 0.0))
    lit = ndc[..., 2] <= occluder + bias
    # outside the light frustum nothing occludes (reference clear = 1.0)
    return torch.where(in_frustum, lit.to(torch.float32), 1.0)
