"""GTAO — ground-truth ambient occlusion (horizon-based), half resolution.

Reference: src/gtao.cpp + shaders/gtao/{main,filter,accum}.comp;
vkr_tpu/passes/gtao.py. Per pixel, march the half-res depth along a
per-pixel screen-space direction (4x4 dither pattern + per-frame angle
offset, main.comp:292-294), track the max horizon cosine with a thickness
break (MAX_THIKNESS=0.1), integrate the GTAO arc term; then a 4x4
depth-bilateral filter and a velocity-reprojected temporal accumulation
with world-space validation.

Ported here: the MIS main pass gtao_main_mis (the default frame's, with
SSR's occlusion estimate), the single-strategy main pass gtao_main_window
(the frame's choice when SSR is off), gtao_filter and gtao_accumulate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vkr_tpu_torch.mathlib.octahedral import decode_normal
from vkr_tpu_torch.mathlib.projection import (
    linearize_depth,
    reconstruct_view_vec,
)
from vkr_tpu_torch.passes.sampling import reproject_bilinear, screen_uv_grid
from vkr_tpu_torch.raster import gather_kernel as _gather

PI = math.pi
MAX_THICKNESS = 0.1   # main.comp MAX_THIKNESS
N_STEPS = 16          # find_horizon(..., 16, w0) in gtao_camera_space

# Per-frame angle offsets (gtao.cpp:109-111). The reference adds libc
# rand()-0.5; vkr_tpu uses a deterministic hash of the frame index instead.
ANGLE_OFFSETS = np.asarray(
    [60.0, 300.0, 180.0, 240.0, 120.0, 0.0,
     300.0, 60.0, 180.0, 120.0, 240.0, 0.0], np.float32
) / np.float32(360.0)


def frame_base_angle(frame_index: int) -> float:
    """base_angle = table[frame % 12] + (hash-random in [-0.5, 0.5)), in
    float32. The hash is uint32 arithmetic: wrap to 32 bits explicitly."""
    offset = ANGLE_OFFSETS[frame_index % 12]
    h = (frame_index * 2654435761 + 1013904223) & 0xFFFFFFFF
    rnd = np.float32(h >> 8) / np.float32(1 << 24) - np.float32(0.5)
    return float(np.float32(offset + rnd))


def gtao_direction_pattern(height: int, width: int, device):
    """main.comp:292-294: (1/16) * ((((x+y)&3)<<2) + (x&3)), per pixel.
    Returns the int class in [0, 16); pattern value = class / 16."""
    x = torch.arange(width, device=device)[None, :]
    y = torch.arange(height, device=device)[:, None]
    return (((x + y) & 3) << 2) + (x & 3)


class GTAOParams(NamedTuple):
    normal_mat: torch.Tensor  # (4,4) world->view normal matrix
    fovy: float
    aspect: float
    znear: float
    zfar: float


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _arc_terms(uv, frag_depth, w0, camera_normal, dir_xy, params):
    """Slice-projected normal terms (gtao_camera_space, main.comp:203-211)."""
    sample_end = reconstruct_view_vec(
        uv + dir_xy, frag_depth, params.fovy, params.aspect,
        params.znear, params.zfar,
    )
    slice_n = torch.linalg.cross(w0, -sample_end, dim=-1)
    slice_n = slice_n / _norm(slice_n, True).clamp(min=1e-20)
    n_proj = camera_normal - (
        (camera_normal * slice_n).sum(-1, keepdim=True) * slice_n
    )
    n_proj_len = _norm(n_proj).clamp(min=1e-20)
    x_axis = -torch.linalg.cross(slice_n, w0, dim=-1)
    x_axis = x_axis / _norm(x_axis, True).clamp(min=1e-20)
    cos_n = ((n_proj / n_proj_len[..., None]) * x_axis).sum(-1)
    n_angle = PI / 2.0 - torch.arccos(cos_n.clamp(-1.0, 1.0))
    return n_proj_len, n_angle


def _arc_integral(h_cos, n_proj_len, n_angle):
    h = torch.arccos(h_cos.clamp(-1.0, 1.0))
    h = torch.minimum(n_angle + torch.clamp(h - n_angle, max=PI / 2.0), h)
    return n_proj_len * 0.25 * torch.clamp(
        -torch.cos(2.0 * h - n_angle) + torch.cos(n_angle)
        + 2.0 * h * torch.sin(n_angle), min=0.0,
    )


def _common(depth_half, normal_half, params):
    """Shared per-pixel terms: uv, view position, view dir, view normal,
    march radius in pixels."""
    H, W = depth_half.shape
    uv = screen_uv_grid(H, W, depth_half.device)
    camera_pos = reconstruct_view_vec(
        uv, depth_half, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    w0 = -camera_pos / _norm(camera_pos, True).clamp(min=1e-20)
    world_n = decode_normal(normal_half)
    cam_n = world_n @ params.normal_mat[:3, :3].T
    cam_n = cam_n / _norm(cam_n, True).clamp(min=1e-20)
    # dir_radius in pixels: min(100/|campos|, 16) (gtao_camera_space)
    radius_px = torch.clamp(100.0 / _norm(camera_pos).clamp(min=1e-20),
                            max=16.0)
    return uv, camera_pos, w0, cam_n, radius_px


def gtao_main_window(depth_half, normal_half, params: GTAOParams,
                     base_angle: float, dirs_count: int = 1):
    """GTAO main pass with the reference's exact sampling: 16 bilinear
    depth taps at fractions 1/16..16/16 of the per-pixel radius
    (gtao_camera_space, main.comp:195-225), all fetched by ONE K4 call per
    direction. Returns (H/2, W/2) raw AO."""
    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px = _common(depth_half, normal_half,
                                                   params)
    cls = gtao_direction_pattern(H, W, depth_half.device).float() / 16.0
    size = torch.tensor([W, H], dtype=torch.float32,
                        device=depth_half.device)

    total = torch.zeros_like(depth_half)
    for d in range(dirs_count):
        angle = 2.0 * PI * (cls + base_angle + d / dirs_count)
        dir_uv = radius_px[..., None] * torch.stack(
            [torch.cos(angle), torch.sin(angle)], -1) / size
        n_proj_len, n_angle = _arc_terms(uv, depth_half, w0, cam_n, dir_uv,
                                         params)
        h_cos = _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params)
        total = total + _arc_integral(h_cos, n_proj_len, n_angle)

    ao = 2.0 * total / dirs_count
    return torch.where(depth_half >= 1.0, 0.0, ao)


def _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params):
    """Max horizon cosine along dir_uv (find_horizon in gtao_camera_space,
    main.comp:195-225): 16 bilinear depth taps at fractions 1/16..16/16 of
    the per-pixel direction, all fetched by ONE K4 call, with the
    thickness break."""
    H, W = depth_half.shape
    fr = (torch.arange(1, N_STEPS + 1, dtype=torch.float32,
                       device=depth_half.device) / N_STEPS)[:, None, None]
    sds = _gather.window_gather_bilinear_multi(
        depth_half.contiguous(), fr * (dir_uv[..., 1] * H)[None],
        fr * (dir_uv[..., 0] * W)[None], radius=N_STEPS)
    h_cos = torch.full_like(depth_half, -1.0)
    prev_z = camera_pos[..., 2]
    alive = torch.ones_like(depth_half, dtype=torch.bool)
    for i in range(1, N_STEPS + 1):
        tc = uv + (float(i) / N_STEPS) * dir_uv
        sp = reconstruct_view_vec(tc, sds[i - 1], params.fovy, params.aspect,
                                  params.znear, params.zfar)
        alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
        prev_z = torch.where(alive, sp[..., 2], prev_z)
        off = sp - camera_pos
        s_cos = (w0 * off).sum(-1) / _norm(off).clamp(min=1e-20)
        h_cos = torch.where(alive, torch.maximum(h_cos, s_cos), h_cos)
    return h_cos


def gtao_main_mis(depth_half, normal_half, material, pdf_lut, ssr_occlusion,
                  params: GTAOParams, base_angle: float,
                  weight_ratio: float = 1.0, reflections_only: bool = False):
    """main.comp mis_gtao (219-274): MIS-combine one uniform-direction GTAO
    arc with the SSR trace's GGX-importance occlusion estimate
    (ssr_occlusion (h, w, 2) = (sum, pdf), ssr.ssr_trace's second output).
    The reference's default main-pass mode (gtao.hpp:112 mis_gtao = true).

    The 16 horizon taps come from one K4 call, as in vkr_tpu's
    use_kernel=True path; the radius is at most 16 px = N_STEPS, so K4's
    +-radius clamp never binds and this equals vkr_tpu's bilinear_sample
    loop (use_kernel=False) up to rounding. material: FULL-res G-buffer
    material (roughness in .g) or an already-half-res (h, w, C) tensor.
    Returns (h, w) raw AO."""
    from vkr_tpu_torch.passes.sampling import downsample_full_to_half
    from vkr_tpu_torch.passes.ssr import sample_ggx_dir_pdf

    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px = _common(depth_half, normal_half,
                                                   params)
    cls = gtao_direction_pattern(H, W, depth_half.device).float() / 16.0
    size = torch.tensor([W, H], dtype=torch.float32,
                        device=depth_half.device)
    angle = 2.0 * PI * (cls + base_angle)
    dir_uv = radius_px[..., None] * torch.stack(
        [torch.cos(angle), torch.sin(angle)], -1) / size

    sample_end = reconstruct_view_vec(uv + dir_uv, depth_half, params.fovy,
                                      params.aspect, params.znear,
                                      params.zfar)
    ldir = sample_end - camera_pos
    ldir = ldir / _norm(ldir, True).clamp(min=1e-20)
    n_proj_len, n_angle = _arc_terms(uv, depth_half, w0, cam_n, dir_uv,
                                     params)

    h_cos = _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params)
    occlusion = (1.0 / PI) * _arc_integral(h_cos, n_proj_len, n_angle)

    # roughness = texture(gbuffer_material, screen_uv).g: half-res pixel
    # centres land between full-res texels, so bilinear = the 2x2 mean
    rough_half = (material[..., 1] if material.shape[:2] == (H, W)
                  else downsample_full_to_half(material[..., 1]))
    ao = ssr_occlusion
    pdf_ggx = sample_ggx_dir_pdf(pdf_lut, w0, cam_n, ldir,
                                 rough_half * rough_half)
    pdf_uniform = 1.0 / (2.0 * PI)

    if reflections_only:
        res = ao[..., 0] / torch.where(ao[..., 1].abs() < 1e-20, 1e-20,
                                       ao[..., 1])
        res = torch.where(torch.isnan(res), 1.0, res)
        return torch.where(depth_half >= 1.0, 0.0, res)

    alpha = 1.0 / (weight_ratio + 1.0)
    beta = 1.0 - alpha
    mw1 = alpha / (alpha * ao[..., 1] + beta * pdf_uniform)
    mw2 = beta / (alpha * pdf_ggx + beta * pdf_uniform)
    mis_ao = ao[..., 0] * mw1 + occlusion * mw2
    mis_ao = torch.where(torch.isnan(mis_ao), occlusion / pdf_uniform,
                         mis_ao)
    return torch.where(depth_half >= 1.0, 0.0, mis_ao)


def gtao_filter(depth_half, raw_ao, znear: float, zfar: float):
    """4x4 depth-bilateral average (filter.comp:32-50): offsets -2..+1,
    weight = max(0, 1 - 5|zs - z| / |z|), edge-clamped taps."""
    h, w = depth_half.shape
    z = linearize_depth(depth_half, znear, zfar)
    pad_d = torch.nn.functional.pad(depth_half[None, None], (2, 2, 2, 2),
                                    mode="replicate")[0, 0]
    pad_ao = torch.nn.functional.pad(raw_ao[None, None], (2, 2, 2, 2),
                                     mode="replicate")[0, 0]
    weight_sum = torch.zeros_like(depth_half)
    ao = torch.zeros_like(depth_half)
    for dx in range(-2, 2):
        for dy in range(-2, 2):
            zs = linearize_depth(
                pad_d[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w], znear, zfar)
            wgt = torch.clamp(1.0 - 5.0 * (zs - z).abs() / z.abs(), min=0.0)
            weight_sum = weight_sum + wgt
            ao = ao + wgt * pad_ao[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]
    return ao / weight_sum.clamp(min=1e-20)


class GTAOAccumParams(NamedTuple):
    inverse_camera: torch.Tensor       # (4,4)
    prev_inverse_camera: torch.Tensor  # (4,4)
    mvp: torch.Tensor                  # (4,4) current unjittered
    fovy: float
    aspect: float
    znear: float
    zfar: float


def gtao_accumulate(depth_half, prev_depth_half, filtered_ao, velocity_half,
                    history, params: GTAOAccumParams, clear_history: bool):
    """Temporal accumulation (accum.comp): velocity reprojection validated
    by world-space reconstruction; running mean with sample count in .y.
    Both reprojections go through K5.

    history: (h, w, 2) = (ao, samples/255). Returns the same shape."""
    h, w = depth_half.shape
    uv = screen_uv_grid(h, w, depth_half.device)
    ts = torch.tensor([w, h], dtype=torch.float32, device=depth_half.device)
    velocity = velocity_half
    prev_uv = uv + velocity
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))

    d_prev = reproject_bilinear(prev_depth_half, velocity)
    v_cam = reconstruct_view_vec(prev_uv, d_prev, params.fovy, params.aspect,
                                 params.znear, params.zfar)
    m = params.prev_inverse_camera
    w_prev = v_cam @ m[:3, :3].T + m[:3, 3]
    prev_h = torch.cat([w_prev, torch.ones_like(w_prev[..., :1])],
                       -1) @ params.mvp.T
    prev_w = prev_h[..., 3:4]
    prev_ndc = prev_h[..., :3] / torch.where(prev_w.abs() < 1e-20, 1e-20,
                                             prev_w)
    prev_world_uv = 0.5 * prev_ndc[..., :2] + 0.5
    delta = (prev_world_uv - uv).abs() * ts

    cur_z = linearize_depth(depth_half, params.znear, params.zfar)
    prev_z = linearize_depth(prev_ndc[..., 2], params.znear, params.zfar)
    depth_err = (prev_z - cur_z).abs()

    vel_delta = torch.maximum(velocity[..., 0].abs() * w,
                              velocity[..., 1].abs() * h)
    error = 0.1 * vel_delta + depth_err
    valid_samples = (1.0 - error).clamp(0.8, 1.0)
    reprojected = (in_bounds
                   & (torch.maximum(delta[..., 0], delta[..., 1]) <= 2.0)
                   & (depth_err < 0.2))
    if clear_history:
        reprojected = torch.zeros_like(reprojected)

    accumulated = reproject_bilinear(history, velocity)
    samples = 255.0 * accumulated[..., 1] * valid_samples
    acc_ao = (accumulated[..., 0] * samples + filtered_ao) / (samples + 1.0)
    samples_next = samples + 1.0
    samples_next = torch.where(samples_next > 255.0, 100.0, samples_next)

    out_ao = torch.where(reprojected, acc_ao, filtered_ao)
    out_samples = torch.where(reprojected, samples_next, 1.0)
    return torch.stack([out_ao.clamp(0.0, 1.0), out_samples / 255.0], -1)
