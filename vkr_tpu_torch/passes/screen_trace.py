"""Screen-space radiance trace (1-bounce SSGI experiment).

Reference: src/screen_trace.{hpp,cpp} + shaders/screen_trace/{trace,filter,
accumulate}.comp; vkr_tpu/passes/screen_trace.py. A GTAO-style horizon
march that also gathers the radiance of visible samples
(integrate_direction, trace.comp:50-80). The reference constructed it in
older revisions and does not wire it into its main loop; vkr_tpu keeps it
for component parity, and no frame of either package calls it.

The 20 samples are a Python loop over tensors (vkr_tpu's fori_loop).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.brdf import distribution_ggx
from vkr_tpu_torch.mathlib.octahedral import decode_normal
from vkr_tpu_torch.mathlib.projection import (
    linearize_depth,
    reconstruct_view_vec,
)
from vkr_tpu_torch.passes.sampling import bilinear_sample, screen_uv_grid

PI = math.pi
MAX_THICKNESS = 0.2   # trace.comp:38
SAMPLES = 20          # trace.comp:39


class ScreenTraceParams(NamedTuple):
    normal_mat: torch.Tensor  # (4,4) world->view normal matrix
    fovy: float
    aspect: float
    znear: float
    zfar: float


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _unit(v):
    return v / _norm(v, True).clamp(min=1e-20)


def _gtao_direction(height, width, device):
    x = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    y = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    return ((((x + y) & 3) << 2) + (x & 3)).float() / 16.0


@register("screen_trace_main")
def screen_trace(depth, normal_oct, color, params: ScreenTraceParams,
                 angle_offset=0.0, dirs_count: int = 1):
    """integrate_direction-based SSGI: marches each pixel's dither direction
    accumulating GGX-weighted radiance of horizon-visible samples.

    Returns (H, W, 4): rgb = radiance, a = GTAO-style visibility; sky pixels
    (depth 1) are (0, 0, 0, 1)."""
    h, w = depth.shape
    dev = depth.device
    lens = (params.fovy, params.aspect, params.znear, params.zfar)
    uv = screen_uv_grid(h, w, dev)

    camera_pos = reconstruct_view_vec(uv, depth, *lens)
    w0 = -camera_pos / _norm(camera_pos, True).clamp(min=1e-20)
    nm = params.normal_mat
    normal = _unit(decode_normal(normal_oct) @ nm[:3, :3].T)

    # trace.comp:169: fixed 256-pixel radius (float32 division, as vkr_tpu)
    dir_radius = torch.from_numpy(
        np.float32(256.0) / np.asarray([w, h], np.float32)).to(dev)
    base_angle = _gtao_direction(h, w, dev) + angle_offset

    total_vis = torch.zeros((h, w), dtype=torch.float32, device=dev)
    total_rad = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

    for d in range(dirs_count):
        angle = 2.0 * PI * (base_angle + d / dirs_count)
        dir_uv = dir_radius * torch.stack([torch.cos(angle),
                                           torch.sin(angle)], -1)

        sample_end = reconstruct_view_vec(uv + dir_uv, depth, *lens)
        slice_n = _unit(torch.linalg.cross(w0, -sample_end, dim=-1))
        n_proj = normal - (normal * slice_n).sum(-1, keepdim=True) * slice_n
        n_len = _norm(n_proj).clamp(min=1e-20)
        to_end = _unit(sample_end - camera_pos)
        n_ang = PI / 2.0 - torch.arccos(
            ((n_proj / n_len[..., None]) * to_end).sum(-1).clamp(-1, 1))

        h_cos = torch.full((h, w), -1.0, device=dev)
        prev_z = camera_pos[..., 2]
        alive = torch.ones((h, w), dtype=torch.bool, device=dev)
        rad = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        rad_n = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for i in range(1, SAMPLES + 1):
            step = float(np.float32(i) / np.float32(SAMPLES))
            tc = uv + step * dir_uv
            sd = bilinear_sample(depth, tc)
            sp = reconstruct_view_vec(tc, sd, *lens)
            alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
            prev_z = torch.where(alive, sp[..., 2], prev_z)
            off = _unit(sp - camera_pos)
            s_cos = (w0 * off).sum(-1)
            visible = alive & (s_cos >= h_cos)
            h_cos = torch.where(visible, s_cos, h_cos)
            half = _unit(w0 + off)
            ggx = distribution_ggx((normal * half).sum(-1), 0.8)
            contrib = (bilinear_sample(color[..., :3], tc)
                       * torch.clamp((normal * off).sum(-1), min=0.0)[..., None]
                       * ggx[..., None])
            rad = rad + torch.where(visible[..., None], contrib, 0.0)
            rad_n = rad_n + visible.float()
        rad = torch.where((rad_n > 0)[..., None], rad / SAMPLES, 0.0)

        hh = torch.arccos(h_cos.clamp(-1.0, 1.0))
        hh = torch.minimum(n_ang + torch.clamp(hh - n_ang, max=PI / 2.0), hh)
        total_vis = total_vis + n_len * 0.25 * torch.clamp(
            -torch.cos(2 * hh - n_ang) + torch.cos(n_ang)
            + 2 * hh * torch.sin(n_ang), min=0.0)
        total_rad = total_rad + rad

    vis = 2.0 * total_vis / dirs_count
    out = torch.cat([total_rad / dirs_count, vis[..., None]], -1)
    sky = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    return torch.where((depth >= 1.0)[..., None], sky, out)


@register("screen_trace_filter")
def screen_trace_filter(depth, raw, znear, zfar):
    """screen_trace/filter.comp: 4x4 depth-bilateral (offsets -2..+1,
    weight 1 - |dz| / (0.1 z))."""
    h, w = depth.shape
    z = linearize_depth(depth, znear, zfar)
    pad_d = torch.nn.functional.pad(depth[None, None], (2, 2, 2, 2),
                                    mode="replicate")[0, 0]
    pad_r = torch.nn.functional.pad(raw.permute(2, 0, 1)[None],
                                    (2, 2, 2, 2),
                                    mode="replicate")[0].permute(1, 2, 0)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    acc = torch.zeros_like(raw)
    for dx in range(-2, 2):
        for dy in range(-2, 2):
            zs = linearize_depth(
                pad_d[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w], znear, zfar)
            wgt = torch.clamp(1.0 - (zs - z).abs() / (z * 0.1), min=0.0)
            wsum = wsum + wgt
            acc = acc + wgt[..., None] * pad_r[2 + dy: 2 + dy + h,
                                               2 + dx: 2 + dx + w]
    return acc / wsum.clamp(min=1e-20)[..., None]


@register("screen_trace_accumulate")
def screen_trace_accumulate(cur_depth, prev_depth, current, accum,
                            fovy, aspect, znear, zfar):
    """screen_trace/accumulate.comp: same-texel depth-validated exponential
    accumulation (coef 0.05)."""
    h, w = cur_depth.shape
    uv = screen_uv_grid(h, w, cur_depth.device)
    cur_view = reconstruct_view_vec(uv, cur_depth, fovy, aspect, znear,
                                    zfar)
    sampled_z = linearize_depth(prev_depth, znear, zfar)
    delta = (sampled_z - cur_view[..., 2]).abs()
    ok = (delta < 1e-6) & (prev_depth < 1.0)
    blended = accum + (current - accum) * 0.05
    return torch.where(ok[..., None], blended, current)
