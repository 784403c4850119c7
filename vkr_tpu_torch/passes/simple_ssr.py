"""Legacy mirror SSR pass (superseded by AdvancedSSR, kept for component
parity — src/ssr.{hpp,cpp} + shaders/ssr/shader.frag; vkr_tpu/passes/
simple_ssr.py).

Mirror reflection R = reflect(view, normal) marched with the plain
hierarchical hi-Z march (screen_trace.glsl:51-101, ssr_march.
hierarchical_march_plain), reflecting the lit frame colour. No frame of
either package calls it.
"""

from __future__ import annotations

import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.octahedral import decode_normal
from vkr_tpu_torch.mathlib.projection import (project_view_vec,
                                              reconstruct_view_vec)
from vkr_tpu_torch.passes.sampling import bilinear_sample, screen_uv_grid
from vkr_tpu_torch.passes.ssr import FlatPyramid, SSRParams, _norm, _unit
from vkr_tpu_torch.passes.ssr_march import hierarchical_march_plain


@register("ssr")
def simple_ssr(hiz: FlatPyramid, normal_oct, frame_color,
               params: SSRParams, max_iterations: int = 100):
    """(H, W) at the pyramid's base resolution -> (H, W, 4) reflection
    colour (a = valid)."""
    h, w = hiz.heights[0], hiz.widths[0]
    dev = hiz.flat.device
    lens = (params.fovy, params.aspect, params.znear, params.zfar)
    uv = screen_uv_grid(h, w, dev)
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)

    depth = hiz.flat[: h * w].reshape(h, w)
    nm = params.normal_mat
    normal = _unit(decode_normal(normal_oct) @ nm[:3, :3].T)
    view_vec = reconstruct_view_vec(uv, depth, *lens)
    r = view_vec - 2.0 * (view_vec * normal).sum(-1, keepdim=True) * normal

    start = project_view_vec(view_vec + 0.0005 * normal, *lens)
    p = project_view_vec(view_vec + r, *lens)
    delta = _unit(p - start)

    dz_ok = delta[..., 2].abs() >= 1e-7

    def safe(d):
        return torch.where(d.abs() < 1e-20, 1e-20, d)

    t_bound = (1.0 - start[..., 2]) / safe(delta[..., 2])
    u_bound = torch.maximum((1.0 - start[..., 0]) / safe(delta[..., 0]),
                            -start[..., 0] / safe(delta[..., 0]))
    v_bound = torch.maximum((1.0 - start[..., 1]) / safe(delta[..., 1]),
                            -start[..., 1] / safe(delta[..., 1]))
    t_bound = torch.minimum(t_bound, torch.minimum(u_bound, v_bound))
    direction = t_bound[..., None] * delta

    out_ray, iters = hierarchical_march_plain(hiz, start, direction,
                                              max_iterations)
    valid = dz_ok & (iters <= max_iterations)

    dist0 = (out_ray[..., :2] - start[..., :2]).abs()
    min_dist = 2.0 / size
    valid = valid & ~((dist0[..., 0] < min_dist[0])
                      & (dist0[..., 1] < min_dist[1]))
    hit_n = decode_normal(
        bilinear_sample(normal_oct, out_ray[..., :2])) @ nm[:3, :3].T
    valid = valid & ((hit_n * r).sum(-1) <= 0)
    hit_depth = bilinear_sample(depth, out_ray[..., :2])
    valid = valid & (out_ray[..., 2] <= hit_depth + 1e-4)

    color = bilinear_sample(frame_color[..., :3], out_ray[..., :2])
    return torch.where(
        valid[..., None],
        torch.cat([color, torch.ones((h, w, 1), device=dev)], -1), 0.0)
