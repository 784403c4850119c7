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
(the frame's choice when SSR is off), the ray-traced main pass gtao_rt
(the frame's choice with gtao.use_ray_query and a scene grid),
gtao_filter and gtao_accumulate; and vkr_tpu's other variants, which no
frame of the port takes: gtao_main_exact, gtao_main_dense,
gtao_normal_space, gtao_reproject and the deinterleaved main pass.

Band mode (row0/band_h, parallel/band.py): the main passes, the filter
and the accumulation compute only the half-res rows [row0, row0 + band_h)
from whole-frame inputs, bit for bit those rows of the full call; the
dither pattern, the uv and the reprojection take global rows, and the
filter's halo replicates the frame's edges.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vkr_ref.core.constants import constant
from vkr_ref.core.registry import register
from vkr_ref.mathlib.octahedral import decode_normal
from vkr_ref.mathlib.projection import (
    linearize_depth,
    project_view_vec,
    reconstruct_view_vec,
)
from vkr_ref.passes.sampling import (band_slice, bilinear_sample,
                                          reproject_bilinear, screen_uv_grid)
from vkr_ref.raster import gather_kernel as _gather
from vkr_ref.scene import accel as _accel

PI = math.pi
MAX_THICKNESS = 0.1   # main.comp MAX_THIKNESS
N_STEPS = 16          # find_horizon(..., 16, w0) in gtao_camera_space
N_CLASSES = 16        # 4x4 dither pattern period

# Per-frame angle offsets (gtao.cpp:109-111). The reference adds libc
# rand()-0.5; vkr_tpu uses a deterministic hash of the frame index instead.
ANGLE_OFFSETS = np.asarray(
    [60.0, 300.0, 180.0, 240.0, 120.0, 0.0,
     300.0, 60.0, 180.0, 120.0, 240.0, 0.0], np.float32
) / np.float32(360.0)
_HASH_MUL = 2654435761
_HASH_ADD = 1013904223


def frame_base_angle(frame_index) -> torch.Tensor:
    """base_angle = table[frame % 12] + (hash-random in [-0.5, 0.5)), a 0-d
    float32 tensor on frame_index's device, computed as vkr_tpu computes
    it (gtao.py:52-58): the hash in uint32 arithmetic, wrapped to 32 bits,
    (h >> 8) in float32, / 2^24 - 0.5, plus the table entry. frame_index:
    a 0-d int32 tensor (FrameState.frame_index) or an int. The product of
    the 32-bit index and the multiplier is taken in 16-bit halves, so no
    int64 intermediate overflows."""
    if not isinstance(frame_index, torch.Tensor):
        frame_index = torch.tensor(frame_index, dtype=torch.int32)
    dev = frame_index.device
    u = frame_index.long() & 0xFFFFFFFF                     # astype(uint32)
    lo = (u & 0xFFFF) * _HASH_MUL
    hi = (((u >> 16) * _HASH_MUL) & 0xFFFF) << 16
    h = (lo + hi + _HASH_ADD) & 0xFFFFFFFF
    rnd = (h >> 8).float() / float(1 << 24) - 0.5
    offset = torch.take(constant(ANGLE_OFFSETS.tolist(), dev),
                        frame_index.long() % 12)
    return offset + rnd


def gtao_direction_pattern(height: int, width: int, device, row0: int = 0):
    """main.comp:292-294: (1/16) * ((((x+y)&3)<<2) + (x&3)), per pixel.
    Returns the int class in [0, 16); pattern value = class / 16. row0
    (band mode): the rows are the global rows row0 + i."""
    x = torch.arange(width, device=device)[None, :]
    y = torch.arange(row0, row0 + height, device=device)[:, None]
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


def _common(depth_half, normal_half, params, row0=None, band_h=None):
    """Shared per-pixel terms: uv, view position, view dir, view normal,
    march radius in pixels, and the centre depth. row0/band_h (band mode,
    vkr_tpu gtao.py:111): the rows [row0, row0 + band_h) only."""
    H, W = depth_half.shape
    h = H if row0 is None else band_h
    depth_c = band_slice(depth_half, row0, h)
    uv = screen_uv_grid(h, W, depth_half.device, row0=row0 or 0,
                        full_height=H)
    camera_pos = reconstruct_view_vec(
        uv, depth_c, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    w0 = -camera_pos / _norm(camera_pos, True).clamp(min=1e-20)
    world_n = decode_normal(band_slice(normal_half, row0, h))
    cam_n = world_n @ params.normal_mat[:3, :3].T
    cam_n = cam_n / _norm(cam_n, True).clamp(min=1e-20)
    # dir_radius in pixels: min(100/|campos|, 16) (gtao_camera_space)
    radius_px = torch.clamp(100.0 / _norm(camera_pos).clamp(min=1e-20),
                            max=16.0)
    return uv, camera_pos, w0, cam_n, radius_px, depth_c


@register("gtao_main")
def gtao_main_window(depth_half, normal_half, params: GTAOParams,
                     base_angle, dirs_count: int = 1,
                     row0: "int | None" = None, band_h: "int | None" = None):
    """GTAO main pass with the reference's exact sampling: 16 bilinear
    depth taps at fractions 1/16..16/16 of the per-pixel radius
    (gtao_camera_space, main.comp:195-225), all fetched by ONE K4 call per
    direction. Returns (H/2, W/2) raw AO (band mode: the band's rows,
    vkr_tpu gtao.py:198)."""
    return _camera_space(depth_half, normal_half, params, base_angle,
                         dirs_count, False, row0, band_h)


@register("gtao_compute_main")
def gtao_main_exact(depth_half, normal_half, params: GTAOParams,
                    base_angle, dirs_count: int = 1,
                    row0: "int | None" = None, band_h: "int | None" = None):
    """gtao_main_window with each of the 16 taps taken by bilinear_sample
    (vkr_tpu's gtao_main_exact, registered as gtao_compute_main: the main
    pass of its use_pallas=False frame). Returns (H/2, W/2) raw AO (band
    mode: the band's rows, vkr_tpu gtao.py:145)."""
    return _camera_space(depth_half, normal_half, params, base_angle,
                         dirs_count, True, row0, band_h)


def _camera_space(depth_half, normal_half, params, base_angle, dirs_count,
                  exact, row0=None, band_h=None):
    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0, band_h)
    h = depth_c.shape[0]
    cls = gtao_direction_pattern(h, W, depth_half.device,
                                 row0 or 0).float() / 16.0
    size = constant([W, H], depth_half.device)

    total = torch.zeros_like(depth_c)
    for d in range(dirs_count):
        angle = 2.0 * PI * (cls + base_angle + d / dirs_count)
        dir_uv = radius_px[..., None] * torch.stack(
            [torch.cos(angle), torch.sin(angle)], -1) / size
        n_proj_len, n_angle = _arc_terms(uv, depth_c, w0, cam_n, dir_uv,
                                         params)
        h_cos = _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params,
                             exact, row0=row0 or 0)
        total = total + _arc_integral(h_cos, n_proj_len, n_angle)

    ao = 2.0 * total / dirs_count
    return torch.where(depth_c >= 1.0, 0.0, ao)


def _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params,
                 exact=False, use_kernel=True, row0=0):
    """Max horizon cosine along dir_uv (find_horizon in gtao_camera_space,
    main.comp:195-225): 16 bilinear depth taps at fractions 1/16..16/16 of
    the per-pixel direction, with the thickness break. The taps come from
    ONE K4 call (its plain version with use_kernel=False), or with
    exact=True from bilinear_sample step by step. uv and the rays cover
    the rows from row0 of the whole depth_half."""
    H, W = depth_half.shape
    if not exact:
        fr = (torch.arange(1, N_STEPS + 1, dtype=torch.float32,
                           device=depth_half.device) / N_STEPS)[:, None, None]
        gather = (_gather.window_gather_bilinear_multi if use_kernel
                  else _gather.window_gather_multi_reference)
        sds = gather(
            depth_half.contiguous(), fr * (dir_uv[..., 1] * H)[None],
            fr * (dir_uv[..., 0] * W)[None], radius=N_STEPS, row0=row0)
    h_cos = torch.full_like(camera_pos[..., 2], -1.0)
    prev_z = camera_pos[..., 2]
    alive = torch.ones_like(h_cos, dtype=torch.bool)
    for i in range(1, N_STEPS + 1):
        tc = uv + (float(i) / N_STEPS) * dir_uv
        sd = bilinear_sample(depth_half, tc) if exact else sds[i - 1]
        sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
        prev_z = torch.where(alive, sp[..., 2], prev_z)
        off = sp - camera_pos
        s_cos = (w0 * off).sum(-1) / _norm(off).clamp(min=1e-20)
        h_cos = torch.where(alive, torch.maximum(h_cos, s_cos), h_cos)
    return h_cos


@register("gtao_main_dense")
def gtao_main_dense(depth_half, normal_half, params: GTAOParams,
                    base_angle, dirs_count: int = 1,
                    row0: "int | None" = None, band_h: "int | None" = None):
    """vkr_tpu's gtao_main_dense: per dither class, march 16 integer-pixel
    offsets round(j * (cos, sin)) of the class's direction as shifts of
    the edge-padded depth image, and keep the arc on the pixels of that
    class. The sample placement differs from the reference's fractional
    steps (gtao_main_exact). Returns (H/2, W/2) raw AO (band mode: the
    band's rows, each shift reading the padded frame's rows around it,
    vkr_tpu gtao.py:265)."""
    H, W = depth_half.shape
    dev = depth_half.device
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0, band_h)
    h = depth_c.shape[0]
    r0 = row0 or 0
    cls_img = gtao_direction_pattern(h, W, dev, r0)
    size = constant([W, H], dev)
    pad = N_STEPS
    dep_pad = torch.nn.functional.pad(depth_half[None, None],
                                      (pad, pad, pad, pad),
                                      mode="replicate")[0, 0]
    dep_pad = dep_pad[r0:r0 + h + 2 * pad]

    f32 = np.float32
    base = f32(float(base_angle))  # a host read: the offsets are host ints
    total = torch.zeros_like(depth_c)
    for d in range(dirs_count):
        ao_d = torch.zeros_like(depth_c)
        for c in range(N_CLASSES):
            # the class's angle in float32, on the host: its integer
            # offsets index the padded image
            angle = f32(2.0 * PI) * (f32(c) / f32(16.0) + base
                                     + f32(d / dirs_count))
            ca, sa = np.cos(angle), np.sin(angle)
            dir_uv = radius_px[..., None] * torch.stack(
                [torch.full_like(depth_c, float(ca)),
                 torch.full_like(depth_c, float(sa))], -1) / size
            n_proj_len, n_angle = _arc_terms(uv, depth_c, w0, cam_n,
                                             dir_uv, params)
            h_cos = torch.full_like(depth_c, -1.0)
            prev_z = camera_pos[..., 2]
            alive = torch.ones_like(depth_c, dtype=torch.bool)
            for j in range(1, N_STEPS + 1):
                ox = int(np.round(f32(j) * ca))
                oy = int(np.round(f32(j) * sa))
                sd = dep_pad[pad + oy: pad + oy + h, pad + ox: pad + ox + W]
                shift = np.array([ox, oy], f32) / np.array([W, H], f32)
                tc = torch.stack([uv[..., 0] + float(shift[0]),
                                  uv[..., 1] + float(shift[1])], -1)
                sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                          params.znear, params.zfar)
                in_r = float(j) <= radius_px
                broken = sp[..., 2] > prev_z + MAX_THICKNESS
                step_alive = alive & in_r & ~broken
                alive = alive & ~(in_r & broken)
                prev_z = torch.where(step_alive, sp[..., 2], prev_z)
                off = sp - camera_pos
                s_cos = (w0 * off).sum(-1) / _norm(off).clamp(min=1e-20)
                h_cos = torch.where(step_alive, torch.maximum(h_cos, s_cos),
                                    h_cos)
            arc = _arc_integral(h_cos, n_proj_len, n_angle)
            ao_d = torch.where(cls_img == c, arc, ao_d)
        total = total + ao_d

    ao = 2.0 * total / dirs_count
    return torch.where(depth_c >= 1.0, 0.0, ao)


def ao_ray_directions(count: int = 64, seed: int = 7):
    """The reference's fixed hemisphere direction set (gtao.cpp:415-440):
    uniform unit vectors with z >= 0, rejection-sampled once per run from
    vkr_tpu's seeded numpy generator, so the same (count, 3) float32
    table."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        v = rng.uniform(-1.0, 1.0, 3)
        v[2] = abs(v[2])
        n = float(np.linalg.norm(v))
        if n <= 1e-5 or n > 1.0:
            continue
        out.append(v / n)
    return np.asarray(out, np.float32)


@register("gtao_rt")
@register("gtao_rt_main")  # manifest name (config.json: gtao/rt_main_frag)
def gtao_rt(depth_half, normal_half, tri_grid, camera_to_world, fovy, aspect,
            znear, zfar, rotation, directions, rt_radius: float = 0.2,
            max_steps: int = 12, dir_chunk: int = 8,
            row0: "int | None" = None, band_h: "int | None" = None):
    """Ray-traced GTAO (shaders/gtao/rt_main.frag): per half-res pixel,
    trace the fixed hemisphere direction set, turned into the surface's
    frame by the per-pixel dither angle plus the per-frame rotation,
    against the scene grid (scene.accel.TriGrid, the TLAS analog);
    AO = 2 * mean(visibility * NdotL). directions: (N, 3) tensor from
    ao_ray_directions. The rays of dir_chunk directions at a time go
    through ray_any_hit(max_steps=12). Returns (H/2, W/2) raw AO (band
    mode: the rows [row0, row0 + band_h), vkr_tpu gtao.py:373)."""
    H, W = depth_half.shape
    h = H if row0 is None else band_h
    dev = depth_half.device
    depth_c = band_slice(depth_half, row0, h)
    uv = screen_uv_grid(h, W, dev, row0=row0 or 0, full_height=H)
    view_vec = reconstruct_view_vec(uv, depth_c, fovy, aspect, znear,
                                    zfar)
    c2w = camera_to_world
    world_pos = view_vec @ c2w[:3, :3].T + c2w[:3, 3]
    n = decode_normal(band_slice(normal_half, row0, h))
    world_pos = world_pos + 1e-6 * n

    # tangent frame and per-pixel dither rotation (rt_main.frag:47-86)
    t = _unit(_tangent(n))
    b = _unit(_accel.cross(n, t))
    t = _accel.cross(b, n)
    cls = gtao_direction_pattern(h, W, dev, row0 or 0).float() / 16.0
    angle = 2.0 * PI * (rotation + cls)
    t = _unit(torch.cos(angle)[..., None] * t
              + torch.sin(angle)[..., None] * b)
    b = _unit(_accel.cross(n, t))
    t = _unit(_accel.cross(b, n))

    n_dirs = directions.shape[0]
    total = torch.zeros_like(depth_c)
    for c0 in range(0, n_dirs, dir_chunk):
        d_loc = _unit(directions[c0: c0 + dir_chunk])  # (C, 3)
        # local -> world per pixel: (H, W, C, 3)
        dw = _unit(d_loc[:, 2:3] * n[..., None, :]
                   + d_loc[:, 0:1] * t[..., None, :]
                   + d_loc[:, 1:2] * b[..., None, :])
        ndl = torch.clamp(_sum3(dw * n[..., None, :]), min=0.0)
        hit = _accel.ray_any_hit(tri_grid, world_pos[..., None, :].expand(
            dw.shape), dw, rt_radius, max_steps=max_steps)
        total = total + torch.where(hit, 0.0, ndl).sum(-1)

    ao = 2.0 * total / n_dirs
    return torch.where(depth_c >= 1.0, 0.0, ao)


def _sum3(v):
    """Sum over the last axis of 3, in order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _unit(v):
    return v / _norm(v, True).clamp(min=1e-20)


def _tangent(n):
    """(n.y, -n.x, 0), or (1, 0, 0) where |n.x| and |n.y| are both below
    1e-5 (main.comp get_tangent, rt_main.frag)."""
    flat = torch.maximum(n[..., 0].abs(), n[..., 1].abs()) < 1e-5
    return torch.stack([torch.where(flat, 1.0, n[..., 1]),
                        torch.where(flat, 0.0, -n[..., 0]),
                        torch.zeros_like(n[..., 0])], -1)


@register("gtao_normal_space")
def gtao_normal_space(depth_half, normal_half, params: GTAOParams,
                      base_angle, dirs_count: int = 1):
    """main.comp gtao_normal_space (148-193): the horizon march against the
    surface normal with the cosine-free (1 - h^2) integration, a radius of
    min(200/|p|, 32) px and 20 steps. Returns (H/2, W/2) AO, 1 on the
    sky."""
    h, w = depth_half.shape
    dev = depth_half.device
    uv = screen_uv_grid(h, w, dev)
    camera_pos = reconstruct_view_vec(uv, depth_half, params.fovy,
                                      params.aspect, params.znear,
                                      params.zfar)

    cam_n = _unit(decode_normal(normal_half) @ params.normal_mat[:3, :3].T)
    tangent = _unit(_tangent(cam_n))
    bitangent = _unit(_accel.cross(cam_n, tangent))
    tangent = _accel.cross(bitangent, cam_n)

    cls = gtao_direction_pattern(h, w, dev).float() / 16.0
    size = constant([w, h], dev)
    radius_px = torch.clamp(200.0 / _norm(camera_pos).clamp(min=1e-20),
                            max=32.0)

    total = torch.zeros_like(depth_half)
    for d in range(dirs_count):
        angle = 2.0 * PI * (cls + base_angle + d / dirs_count)
        sample_vec = (torch.cos(angle)[..., None] * tangent
                      + torch.sin(angle)[..., None] * bitangent)
        sdir = project_view_vec(camera_pos + sample_vec, params.fovy,
                                params.aspect, params.znear,
                                params.zfar)[..., :2] - uv
        dir_uv = radius_px[..., None] * _unit(sdir) / size

        h_cos = torch.full_like(depth_half, -1.0)
        prev_z = camera_pos[..., 2]
        alive = torch.ones_like(depth_half, dtype=torch.bool)
        for i in range(1, 21):
            tc = uv + (float(i) / 20.0) * dir_uv
            sd = bilinear_sample(depth_half, tc)
            sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                      params.znear, params.zfar)
            alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
            prev_z = torch.where(alive, sp[..., 2], prev_z)
            off = sp - camera_pos
            s_cos = (cam_n * off).sum(-1) / _norm(off).clamp(min=1e-20)
            h_cos = torch.where(alive, torch.maximum(h_cos, s_cos), h_cos)
        h_cos = torch.clamp(h_cos, min=0.0)
        total = total + (1.0 - h_cos * h_cos)

    return torch.where(depth_half >= 1.0, 1.0, total / dirs_count)


@register("gtao_main_mis")
def gtao_main_mis(depth_half, normal_half, material, pdf_lut, ssr_occlusion,
                  params: GTAOParams, base_angle,
                  weight_ratio: float = 1.0, reflections_only: bool = False,
                  use_kernel: bool = True, row0: "int | None" = None,
                  band_h: "int | None" = None):
    """main.comp mis_gtao (219-274): MIS-combine one uniform-direction GTAO
    arc with the SSR trace's GGX-importance occlusion estimate
    (ssr_occlusion (h, w, 2) = (sum, pdf), ssr.ssr_trace's second output).
    The reference's default main-pass mode (gtao.hpp:112 mis_gtao = true).

    The 16 horizon taps come from one K4 call (its plain version with
    use_kernel=False), as in vkr_tpu's use_kernel=True path; the radius is at most 16 px = N_STEPS, so K4's
    +-radius clamp never binds and this equals vkr_tpu's bilinear_sample
    loop (use_kernel=False) up to rounding. material: FULL-res G-buffer
    material (roughness in .g) or an already-half-res (h, w, C) tensor.
    Returns (h, w) raw AO. row0/band_h (band mode, vkr_tpu gtao.py:537):
    the rows [row0, row0 + band_h), from the whole depth, normals and SSR
    occlusion."""
    from vkr_ref.passes.sampling import downsample_full_to_half
    from vkr_ref.passes.ssr import sample_ggx_dir_pdf

    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0, band_h)
    h = depth_c.shape[0]
    cls = gtao_direction_pattern(h, W, depth_half.device,
                                 row0 or 0).float() / 16.0
    size = constant([W, H], depth_half.device)
    angle = 2.0 * PI * (cls + base_angle)
    dir_uv = radius_px[..., None] * torch.stack(
        [torch.cos(angle), torch.sin(angle)], -1) / size

    sample_end = reconstruct_view_vec(uv + dir_uv, depth_c, params.fovy,
                                      params.aspect, params.znear,
                                      params.zfar)
    ldir = sample_end - camera_pos
    ldir = ldir / _norm(ldir, True).clamp(min=1e-20)
    n_proj_len, n_angle = _arc_terms(uv, depth_c, w0, cam_n, dir_uv,
                                     params)

    h_cos = _horizon_cos(depth_half, uv, camera_pos, w0, dir_uv, params,
                         use_kernel=use_kernel, row0=row0 or 0)
    occlusion = (1.0 / PI) * _arc_integral(h_cos, n_proj_len, n_angle)

    # roughness = texture(gbuffer_material, screen_uv).g: half-res pixel
    # centres land between full-res texels, so bilinear = the 2x2 mean
    rough_half = band_slice(
        material[..., 1] if material.shape[:2] == (H, W)
        else downsample_full_to_half(material[..., 1]), row0, h)
    ao = band_slice(ssr_occlusion, row0, h)
    pdf_ggx = sample_ggx_dir_pdf(pdf_lut, w0, cam_n, ldir,
                                 rough_half * rough_half)
    pdf_uniform = 1.0 / (2.0 * PI)

    if reflections_only:
        res = ao[..., 0] / torch.where(ao[..., 1].abs() < 1e-20, 1e-20,
                                       ao[..., 1])
        res = torch.where(torch.isnan(res), 1.0, res)
        return torch.where(depth_c >= 1.0, 0.0, res)

    alpha = 1.0 / (weight_ratio + 1.0)
    beta = 1.0 - alpha
    mw1 = alpha / (alpha * ao[..., 1] + beta * pdf_uniform)
    mw2 = beta / (alpha * pdf_ggx + beta * pdf_uniform)
    mis_ao = ao[..., 0] * mw1 + occlusion * mw2
    mis_ao = torch.where(torch.isnan(mis_ao), occlusion / pdf_uniform,
                         mis_ao)
    return torch.where(depth_c >= 1.0, 0.0, mis_ao)


@register("gtao_reproject")
def gtao_reproject(current_depth, prev_depth, current_ao, prev_ao,
                   camera_to_prev_frame, fovy, aspect, znear, zfar,
                   matrix_mode: bool = False, bias: float = 1e-6):
    """gtao/reproject.comp:27-68: the standalone AO temporal reprojection
    (matrix-based; gtao_accumulate reprojects by velocity instead). The
    default is the shader's compiled-in STATIC_REPROJECT mode
    (reproject.comp:6): where the same pixel's depth matches,
    ao = mix(prev_ao, new_ao, 0.05). matrix_mode=True is MATRIX_REPROJECT:
    the view-space point goes through camera_to_prev_frame and the previous
    frame is bilinear-sampled there. bias: REPROJECT_BIAS
    (reproject.comp:8), a tolerance on linearized depth that in matrix mode
    admits only bit-stable round trips, as compiled into the shader."""
    coef = 0.05  # REPROJECT_COEF
    h, w = current_depth.shape
    dev = current_depth.device
    new_ao = current_ao
    # reproject.comp:30 uses uv = pixel/size (no half-texel centre)
    uv = screen_uv_grid(h, w, dev) - 0.5 / constant([w, h], dev)
    cur_view = reconstruct_view_vec(uv, current_depth, fovy, aspect, znear,
                                    zfar)
    if matrix_mode:
        m = camera_to_prev_frame
        rep = cur_view @ m[:3, :3].T + m[:3, 3]
        rep_w = (cur_view * m[3, :3]).sum(-1) + m[3, 3]
        prev_view = rep / torch.where(rep_w.abs() < 1e-20, 1e-20,
                                      rep_w)[..., None]
        prev_xy = 0.5 * prev_view[..., :2] + 0.5
        in_bounds = ((prev_xy[..., 0] > 0) & (prev_xy[..., 0] < 1)
                     & (prev_xy[..., 1] > 0) & (prev_xy[..., 1] < 1))
        sampled_depth = bilinear_sample(prev_depth, prev_xy)
        sampled_ao = bilinear_sample(prev_ao, prev_xy)
        rep_z = linearize_depth(prev_view[..., 2], znear, zfar)
        sampled_z = linearize_depth(sampled_depth, znear, zfar)
        keep = (in_bounds & ((rep_z - sampled_z).abs() < bias)
                & (sampled_depth < 1.0))
    else:
        sampled_depth = prev_depth
        sampled_ao = prev_ao
        sampled_z = linearize_depth(sampled_depth, znear, zfar)
        keep = ((sampled_z - cur_view[..., 2]).abs() < bias) & (
            sampled_depth < 1.0)
    blended = sampled_ao + coef * (new_ao - sampled_ao)  # mix(a, b, t)
    return torch.where(keep, blended, new_ao)


@register("deinterleave_depth")
def deinterleave_depth(depth, pattern_step: int = 2):
    """gtao_opt/deinterleave.comp: (H, W) -> (layers, H>>n, W>>n), layer
    ((y & mask) << n) + (x & mask): each layer is one phase of the
    2^n x 2^n dither lattice."""
    s = 1 << pattern_step
    h, w = depth.shape
    h2, w2 = h // s, w // s
    d = depth[: h2 * s, : w2 * s].reshape(h2, s, w2, s)
    return d.permute(1, 3, 0, 2).reshape(s * s, h2, w2)


def interleave_layers(layers, pattern_step: int = 2):
    """Inverse of deinterleave_depth."""
    s = 1 << pattern_step
    _, h2, w2 = layers.shape
    return layers.reshape(s, s, h2, w2).permute(2, 0, 3, 1).reshape(
        h2 * s, w2 * s)


@register("main_deinterleaved")
def gtao_main_deinterleaved(depth_half, normal_half, params: GTAOParams,
                            base_angle, pattern_step: int = 2):
    """gtao_opt/main_deinterleaved.comp: gtao_main_exact on each dither
    layer (the layer's pixels share a direction class), with base angle
    base_angle + l / layers, then re-interleaved. The reference constructs
    it but its main loop does not run it (SURVEY.md section 2.4)."""
    layers = (1 << pattern_step) ** 2
    d_layers = deinterleave_depth(depth_half, pattern_step)
    n_layers = torch.stack([deinterleave_depth(normal_half[..., k],
                                               pattern_step)
                            for k in range(2)], -1)
    base_angle = torch.as_tensor(base_angle, dtype=torch.float32)
    outs = [gtao_main_exact(d_layers[l], n_layers[l], params,
                            base_angle + float(np.float32(l / float(layers))))
            for l in range(layers)]
    return interleave_layers(torch.stack(outs), pattern_step)


@register("gtao_filter")
def gtao_filter(depth_half, raw_ao, znear: float, zfar: float,
                row0: "int | None" = None, band_h: "int | None" = None):
    """4x4 depth-bilateral average (filter.comp:32-50): offsets -2..+1,
    weight = max(0, 1 - 5|zs - z| / |z|), edge-clamped taps. row0/band_h
    (band mode, vkr_tpu gtao.py:767): the rows [row0, row0 + band_h) from
    the whole depth and raw AO, a 2-row halo replicating the frame's
    edges."""
    H, w = depth_half.shape
    h = H if row0 is None else band_h
    r0 = row0 or 0
    depth_c = band_slice(depth_half, row0, h)
    z = linearize_depth(depth_c, znear, zfar)

    def halo(a):
        return torch.nn.functional.pad(a[None, None], (2, 2, 2, 2),
                                       mode="replicate")[0, 0][r0:r0 + h + 4]

    pad_d = halo(depth_half)
    pad_ao = halo(raw_ao)
    weight_sum = torch.zeros_like(depth_c)
    ao = torch.zeros_like(depth_c)
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


@register("gtao_accumulate")
def gtao_accumulate(depth_half, prev_depth_half, filtered_ao, velocity_half,
                    history, params: GTAOAccumParams, clear_history,
                    use_kernel_gather: bool = True,
                    row0: "int | None" = None, band_h: "int | None" = None):
    """Temporal accumulation (accum.comp): velocity reprojection validated
    by world-space reconstruction; running mean with sample count in .y.
    Both reprojections go through K5, or its plain version with
    use_kernel_gather=False.

    history: (h, w, 2) = (ao, samples/255). Returns the same shape.
    clear_history: a bool, or the frame's 0-d bool tensor (frame_index ==
    0), which drops the history through torch.where as in vkr_tpu
    (gtao.py:895), with no host read.
    row0/band_h (band mode, vkr_tpu gtao.py:821): the rows [row0, row0 +
    band_h) from whole-frame inputs. The velocity's pixel length scales by
    the frame's height; vkr_tpu's band form takes the band's height there
    (gtao.py:886-887, ROADMAP queue 3)."""
    H, w = depth_half.shape
    h = H if row0 is None else band_h
    r0 = row0 or 0
    uv = screen_uv_grid(h, w, depth_half.device, row0=r0, full_height=H)
    ts = constant([w, H], depth_half.device)
    depth_c = band_slice(depth_half, row0, h)
    velocity = band_slice(velocity_half, row0, h)
    prev_uv = uv + velocity
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))

    d_prev = reproject_bilinear(prev_depth_half, velocity,
                                use_kernel=use_kernel_gather, row0=r0)
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

    cur_z = linearize_depth(depth_c, params.znear, params.zfar)
    prev_z = linearize_depth(prev_ndc[..., 2], params.znear, params.zfar)
    depth_err = (prev_z - cur_z).abs()

    vel_delta = torch.maximum(velocity[..., 0].abs() * w,
                              velocity[..., 1].abs() * H)
    error = 0.1 * vel_delta + depth_err
    valid_samples = (1.0 - error).clamp(0.8, 1.0)
    reprojected = (in_bounds
                   & (torch.maximum(delta[..., 0], delta[..., 1]) <= 2.0)
                   & (depth_err < 0.2))
    if isinstance(clear_history, torch.Tensor):  # the frame's predicate
        reprojected = torch.where(clear_history, False, reprojected)
    elif clear_history:
        reprojected = torch.zeros_like(reprojected)

    accumulated = reproject_bilinear(history, velocity,
                                     use_kernel=use_kernel_gather, row0=r0)
    filtered_ao = band_slice(filtered_ao, row0, h)
    samples = 255.0 * accumulated[..., 1] * valid_samples
    acc_ao = (accumulated[..., 0] * samples + filtered_ao) / (samples + 1.0)
    samples_next = samples + 1.0
    samples_next = torch.where(samples_next > 255.0, 100.0, samples_next)

    out_ao = torch.where(reprojected, acc_ao, filtered_ao)
    out_samples = torch.where(reprojected, samples_next, 1.0)
    return torch.stack([out_ao.clamp(0.0, 1.0), out_samples / 255.0], -1)
