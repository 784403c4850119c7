"""Octahedral light-probe renderer and probe-grid reflection trace.

The port of vkr_tpu/passes/probes.py (reference: src/probe_renderer.
{hpp,cpp} + shaders/{cubemap_probe,cube2oct,probe_downsample,
trace_probe}):
  1. render_probe_cubemap: the scene rastered 6x from the probe position
     (90 deg fov) by the G-buffer pass, so through K1, into albedo colour
     and view distance;
  2. cube_to_oct: the cubemap resampled to an octahedral map, with planar
     depth along the octant diagonal (cube2oct/shader.comp);
  3. oct_depth_pyramid: min 2x2 mips of that depth (probe_downsample);
  4. probe_trace: per G-buffer pixel, the reflected ray marched
     hierarchically through the octahedral depth of up to 4 neighbouring
     probes, in up to 4 octant segments each (trace_probe/shader.comp).

Steps 2-4 are plain PyTorch on the tensors' device: vkr_tpu computes them
outside any Pallas kernel. probe_trace marches every (neighbour, segment)
pair as one batch, then takes per pixel the first pair that settles in
vkr_tpu's loop order, which is what its nested loops keep.

Arithmetic follows vkr_tpu's: a Python scalar over a tensor is one
division (PyTorch would take the reciprocal and multiply), 2^-mip is exact,
and float-to-int casts truncate toward zero and saturate, as XLA's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vkr_ref.core.registry import register
from vkr_ref.mathlib.octahedral import (decode_normal, oct_decode_dir,
                                        oct_encode_dir)
from vkr_ref.mathlib.projection import reconstruct_view_vec
from vkr_ref.mathlib.transforms import look_at, perspective
from vkr_ref.passes.gbuffer import SceneDevice, render_gbuffer
from vkr_ref.passes.sampling import (band_slice, bilinear_sample,
                                     screen_uv_grid)
from vkr_ref.passes.ssr_march import MAX_T

ZNEAR = 0.05   # cube2oct/shader.comp:10
ZFAR = 80.0
TRACE_STEPS = 25
FOV = math.radians(90.0)
BACKGROUND = (100.0, 0.0, 0.0)  # clear colour 100 (probe_renderer.cpp:135)

# Vulkan cubemap face (look, up) conventions.
_FACES = [
    ((1, 0, 0), (0, -1, 0)),
    ((-1, 0, 0), (0, -1, 0)),
    ((0, 1, 0), (0, 0, 1)),
    ((0, -1, 0), (0, 0, -1)),
    ((0, 0, 1), (0, -1, 0)),
    ((0, 0, -1), (0, -1, 0)),
]


def _div(num: float, t):
    """num / t rounded once."""
    return torch.full_like(t, num) / t


def _trunc(x):
    """float -> int32 toward zero, saturating like XLA's cast (a fetch
    index is clamped to its range afterwards)."""
    return x.clamp(-1.0, 16777216.0).to(torch.int32)


def _length(v):
    # rounds as jnp.linalg.norm does, where sqrt((v * v).sum()) would not
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unit(v):
    return v / _length(v).clamp(min=1e-20)


def encode_oct_depth(z, n=ZNEAR, f=ZFAR):
    """octahedral.glsl:70-72 (planar depth along the octant diagonal)."""
    return f / (f - n) + _div(f * n, (-z) * (f - n))


def decode_oct_depth(d, n=ZNEAR, f=ZFAR):
    return _div(-n * f, d * (f - n) - f)


def oct_center(uv):
    """octahedral.glsl oct_center: the octant diagonal direction."""
    u = 2.0 * (uv - 0.5)
    z = 1.0 - u[..., 0].abs() - u[..., 1].abs()
    v = torch.cat([u, z[..., None]], -1)
    s = torch.where(v >= 0.0, 1.0, -1.0)
    # sign(0) = 0 in GLSL sign(); match it for exact parity
    s = torch.where(v == 0.0, 0.0, s)
    return s / _length(s).clamp(min=1e-20)


class Probe(NamedTuple):
    color: torch.Tensor                  # (S, S, 3) octahedral albedo
    depth_mips: Tuple[torch.Tensor, ...]  # oct depth pyramid, base first
    face_overflow: torch.Tensor          # (6,) int32 bin pairs dropped
    face_coverage: torch.Tensor          # (6,) share of covered texels


@register("cubemap_probe")
def render_probe_cubemap(scene: SceneDevice, position, cube_size: int = 128,
                         oracle: bool = False):
    """Raster the scene 6x from `position`. Returns (color (6, S, S, 3),
    distance (6, S, S), bin pairs dropped (6,), covered share (6,)).
    oracle: the brute-force G-buffer (render_gbuffer(oracle=True))."""
    dev = scene.corner_world_o.device
    proj = perspective(FOV, 1.0, ZNEAR, ZFAR)
    pos = np.asarray(position, np.float32)
    uv = screen_uv_grid(cube_size, cube_size, dev)
    background = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev)
    no_jitter = torch.zeros(2, dtype=torch.float32, device=dev)
    colors, dists, overflow, coverage = [], [], [], []
    for look, up in _FACES:
        view = look_at(pos, pos + np.asarray(look, np.float32),
                       np.asarray(up, np.float32))
        vp = torch.as_tensor(proj @ view, device=dev)
        g = render_gbuffer(scene, vp, vp, no_jitter, width=cube_size,
                           height=cube_size, quantize=False,
                           oracle=oracle)
        view_pos = reconstruct_view_vec(uv, g.depth, FOV, 1.0, ZNEAR, ZFAR)
        bg = g.depth >= 1.0
        colors.append(torch.where(bg[..., None], background,
                                  g.albedo[..., :3]))
        dists.append(torch.where(bg, 100.0, _length(view_pos)[..., 0]))
        overflow.append(g.overflow)
        coverage.append((~bg).float().mean())
    return (torch.stack(colors), torch.stack(dists), torch.stack(overflow),
            torch.stack(coverage))


def sample_cubemap(faces, direction):
    """samplerCube lookup: face select + bilinear within the face.

    faces: (6, S, S, C) in _FACES order; direction: (..., 3).
    """
    x, y, z = direction.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()

    # face index by dominant axis
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3),
                    torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-20)
    # standard cubemap (s, t) per face
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y,
                     torch.where(is_y, torch.where(y > 0, z, -z), -y))
    uv = torch.stack([(sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5], -1)

    taps = torch.stack([bilinear_sample(faces[i], uv) for i in range(6)])
    sel = face[None, ..., None] if faces.ndim == 4 else face[None]
    return taps.gather(0, sel.expand((1,) + taps.shape[1:]))[0]


@register("cube2oct")
def cube_to_oct(color_faces, dist_faces, oct_size: int = 256):
    """cube2oct/shader.comp: octahedral resample + planar depth encode.

    NOTE: the shader uses uv = pixel/size (no half-texel offset)."""
    xs = torch.arange(oct_size, dtype=torch.float32,
                      device=color_faces.device) / oct_size
    uv = torch.stack(torch.meshgrid(xs, xs, indexing="xy"), -1)
    direction = oct_decode_dir(uv)
    color = sample_cubemap(color_faces, direction)
    dist = sample_cubemap(dist_faces[..., None], direction)[..., 0]
    view_dir = direction * dist[..., None]
    front = oct_center(uv)
    # planar depth along the octant diagonal, a positive distance like the
    # reference's (cube2oct/shader.comp:27)
    depth = encode_oct_depth((view_dir * front).sum(-1).clamp(ZNEAR, ZFAR))
    return color, depth


@register("probe_downsample")
def oct_depth_pyramid(oct_depth) -> Tuple[torch.Tensor, ...]:
    """probe_downsample: min 2x2 chain."""
    mips = [oct_depth]
    cur = oct_depth
    while min(cur.shape) > 1:
        h, w = cur.shape
        cur = cur[: h // 2 * 2, : w // 2 * 2].reshape(
            h // 2, 2, w // 2, 2).amin(dim=(1, 3))
        mips.append(cur)
    return tuple(mips)


def render_probe(scene: SceneDevice, position, cube_size: int = 128,
                 oct_size: int = 256, oracle: bool = False) -> Probe:
    """ProbeRenderer::render_probe: cubemap -> octahedral map + depth mips."""
    color_faces, dist_faces, overflow, coverage = render_probe_cubemap(
        scene, position, cube_size, oracle=oracle)
    color, depth = cube_to_oct(color_faces, dist_faces, oct_size)
    return Probe(color=color, depth_mips=oct_depth_pyramid(depth),
                 face_overflow=overflow, face_coverage=coverage)


class ProbeGrid(NamedTuple):
    """OctahedralProbeGrid (probe_renderer.cpp:251-288): grid_size^2 probes
    on the y-plane between probe_min and probe_max."""

    colors: torch.Tensor          # (P, S, S, 3)
    depth_flat: torch.Tensor      # (P, sum of mip texels) packed pyramids
    mip_offsets: Tuple[int, ...]
    mip_sizes: Tuple[int, ...]
    probe_min: torch.Tensor       # (3,)
    probe_max: torch.Tensor       # (3,)
    grid_size: int
    # (P, 6) per cubemap face: bin pairs dropped, share of covered texels.
    # None for a grid carried across from vkr_tpu, which keeps neither.
    face_overflow: Optional[torch.Tensor] = None
    face_coverage: Optional[torch.Tensor] = None


def render_probe_grid(scene: SceneDevice, probe_min, probe_max,
                      grid_size: int, cube_size: int = 128,
                      oct_size: int = 256, oracle: bool = False) -> ProbeGrid:
    dev = scene.corner_world_o.device
    pmin = np.asarray(probe_min, np.float32)
    pmax = np.asarray(probe_max, np.float32)
    step = (pmax - pmin) / max(grid_size - 1, 1)
    probes = []
    for y in range(grid_size):
        for x in range(grid_size):
            pos = pmin + np.array([x, 0, y], np.float32) * step
            probes.append(render_probe(scene, pos, cube_size, oct_size,
                                       oracle=oracle))
    offsets, off = [], 0
    for m in probes[0].depth_mips:
        offsets.append(off)
        off += m.numel()
    return ProbeGrid(
        colors=torch.stack([p.color for p in probes]),
        depth_flat=torch.stack([torch.cat([m.reshape(-1)
                                           for m in p.depth_mips])
                                for p in probes]),
        mip_offsets=tuple(offsets),
        mip_sizes=tuple(int(m.shape[0]) for m in probes[0].depth_mips),
        probe_min=torch.as_tensor(pmin, device=dev),
        probe_max=torch.as_tensor(pmax, device=dev),
        grid_size=grid_size,
        face_overflow=torch.stack([p.face_overflow for p in probes]),
        face_coverage=torch.stack([p.face_coverage for p in probes]),
    )


def _mip_tables(grid: ProbeGrid):
    """(offsets, sizes) of the packed mips as int32 tensors, built on the
    device (a tensor made from host values would synchronise the stream):
    mip m of the min 2x2 chain is (S >> m)^2 texels."""
    n = len(grid.mip_sizes)
    sizes = [grid.mip_sizes[0] >> m for m in range(n)]
    offsets = [sum(s * s for s in sizes[:m]) for m in range(n)]
    if tuple(sizes) != grid.mip_sizes or tuple(offsets) != grid.mip_offsets:
        raise ValueError(f"probe grid mips {grid.mip_sizes} at "
                         f"{grid.mip_offsets} are not a min 2x2 chain")
    t = grid.mip_sizes[0] >> torch.arange(n, dtype=torch.int32,
                                          device=grid.depth_flat.device)
    return torch.cumsum(t * t, 0, dtype=torch.int32) - t * t, t


def _fetch_probe_depth(grid: ProbeGrid, tables, probe_idx, mip, x, y):
    offsets, sizes = tables
    offs = offsets[mip.long()]
    s = sizes[mip.long()]
    xi = torch.minimum(x.clamp(min=0), s - 1)
    yi = torch.minimum(y.clamp(min=0), s - 1)
    flat_idx = offs + yi * s + xi
    stride = grid.depth_flat.shape[1]
    idx = probe_idx.clamp(0, grid.colors.shape[0] - 1) * stride + flat_idx
    return grid.depth_flat.reshape(-1)[idx.long()]


def _pow2_neg(mip):
    """2^-mip, exact, from its float32 bits (vkr_tpu's exp2 is exact for
    the mips a probe pyramid has)."""
    return ((127 - mip) << 23).view(torch.float32)


def _inv_dir(d):
    return torch.where(d != 0.0, 1.0 / torch.where(d == 0.0, 1.0, d), MAX_T)


def _probe_march(grid, tables, probe_idx, origin, direction, max_iters):
    """hierarchical_raymarch over a probe's oct depth pyramid
    (trace_probe/shader.comp:218-268; t clamped to 1)."""
    base = float(grid.mip_sizes[0])
    n_mips = len(grid.mip_sizes)
    inv_dir = _inv_dir(direction)
    uv_off_mag = 0.005 / base
    uv_offset = torch.where(direction[..., :2] < 0, -uv_off_mag, uv_off_mag)
    floor_offset = torch.where(direction[..., :2] < 0, 0.0, 1.0)

    cur_pos = base * origin[..., :2]
    xy_plane = (torch.floor(cur_pos) + floor_offset) / base + uv_offset
    t0 = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
    current_t = torch.minimum(t0[..., 0], t0[..., 1])
    position = origin + current_t[..., None] * direction

    shape = origin.shape[:-1]
    mip = torch.zeros(shape, dtype=torch.int32, device=origin.device)
    done = torch.zeros(shape, dtype=torch.bool, device=origin.device)
    iters = torch.zeros(shape, dtype=torch.int32, device=origin.device)
    for i in range(max_iters):
        mip_res = base * _pow2_neg(mip)
        mip_pos = mip_res[..., None] * position[..., :2]
        surface_z = _fetch_probe_depth(
            grid, tables, probe_idx, mip.clamp(0, n_mips - 1),
            _trunc(mip_pos[..., 0]), _trunc(mip_pos[..., 1]))
        xy_plane = ((torch.floor(mip_pos) + floor_offset)
                    / mip_res[..., None] + uv_offset)
        t_xy = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
        t_z = (surface_z - origin[..., 2]) * inv_dir[..., 2]
        t_z = torch.where(direction[..., 2] > 0, t_z, MAX_T)
        t_min = torch.minimum(torch.minimum(t_xy[..., 0], t_xy[..., 1]),
                              t_z).clamp(max=1.0)
        above = surface_z > position[..., 2]
        skipped = (t_min != t_z) & above
        new_t = torch.where(above, t_min, current_t).clamp(-1e20, 1e20)
        new_pos = origin + new_t[..., None] * direction
        new_mip = mip + (2 * skipped.to(torch.int32) - 1)
        act = ~done
        position = torch.where(act[..., None], new_pos, position)
        current_t = torch.where(act, new_t, current_t)
        mip = torch.where(act, new_mip, mip)
        done = done | (new_mip < 0)
        iters = torch.where(act, i + 1, iters)

    iters = torch.where(done, iters, max_iters + 1)
    pos = torch.where(torch.isfinite(position), position, 0.0)
    return pos.clamp(-1e6, 1e6), iters <= max_iters


def _trace_segment(grid, tables, probe_idx, ray_origin, ray_dir, t0, t1):
    """trace_segment_hi (trace_probe/shader.comp:270-323).

    Returns (result code 0=miss 1=hit 2=unknown, hit oct uv)."""
    eps = 0.001
    p_start3 = ray_origin + ray_dir * (t0 + eps)[..., None]
    p_end3 = ray_origin + ray_dir * (t1 - eps)[..., None]
    degenerate = ((p_end3 - p_start3) ** 2).sum(-1) < 0.001
    p_start3 = torch.where(degenerate[..., None], ray_dir, p_start3)

    start_oct = oct_encode_dir(_unit(p_start3))
    end_oct = oct_encode_dir(_unit(p_end3))
    front = oct_center(0.5 * (start_oct + end_oct))

    # positive planar distances (trace_probe/shader.comp:291-293)
    start_depth = encode_oct_depth(
        (p_start3 * front).sum(-1).clamp(min=1e-6)) - 0.0005
    end_depth = encode_oct_depth((p_end3 * front).sum(-1).clamp(min=1e-6))
    p_start = torch.cat([start_oct, start_depth[..., None]], -1)
    p_end = torch.cat([end_oct, end_depth[..., None]], -1)

    p_stop, valid = _probe_march(grid, tables, probe_idx, p_start,
                                 p_end - p_start, TRACE_STEPS)
    size = grid.mip_sizes[0]
    sampled = _fetch_probe_depth(
        grid, tables, probe_idx, torch.zeros_like(probe_idx),
        _trunc(p_stop[..., 0] * size), _trunc(p_stop[..., 1] * size))
    bias = 0.0005
    z = p_stop[..., 2]
    result = torch.where(z > sampled - bias, 1, 0)
    result = torch.where(z > sampled + bias, 2, result)
    result = torch.where(~valid | (z > 1.0), 0, result)
    return result, p_stop[..., :2]


def _segments(origin, inv_dir, tmin, tmax):
    """compute_trace_segments: split the ray at octant plane crossings."""
    t = torch.sort(-origin * inv_dir, dim=-1).values.clamp(tmin, tmax)
    edge = torch.full_like(t[..., 0], tmin)
    return [edge, t[..., 0], t[..., 1], t[..., 2],
            torch.full_like(edge, tmax)]


@register("trace_probe")
def probe_trace(depth, normal_oct, grid: ProbeGrid, inverse_view, fovy,
                aspect, znear, zfar, row0: "int | None" = None,
                band_h: "int | None" = None):
    """ProbeTracePass: per-pixel probe-grid reflection
    (trace_probe/shader.comp main + trace over neighbor probes). depth
    (H, W), normal_oct (H, W, 2), inverse_view (4, 4). Returns (H, W, 4):
    probe colour and 1 where a probe hit, else 0. row0/band_h (band mode,
    vkr_tpu probes.py:382): the rows [row0, row0 + band_h) only."""
    H, w = depth.shape
    h = H if row0 is None else band_h
    depth = band_slice(depth, row0, h)
    normal_oct = band_slice(normal_oct, row0, h)
    dev = depth.device
    uv = screen_uv_grid(h, w, dev, row0=row0 or 0, full_height=H)
    view_vec = reconstruct_view_vec(uv, depth, fovy, aspect, znear, zfar)
    inv = inverse_view
    n = decode_normal(normal_oct)
    world_pos = view_vec @ inv[:3, :3].T + inv[:3, 3]
    world_pos = world_pos + 1e-6 * n
    v = _unit(world_pos - inv[:3, 3])
    world_pos = world_pos - 1e-6 * v
    r = v - 2.0 * (v * n).sum(-1, keepdim=True) * n

    gs = grid.grid_size
    pstep = ((grid.probe_max - grid.probe_min)
             / torch.full_like(grid.probe_min, max(gs - 1, 1)))
    coord = ((world_pos - grid.probe_min)
             / torch.where(pstep.abs() < 1e-9, 1.0, pstep)
             ).clamp(0.0, gs - 2 if gs > 1 else 0)
    sx = _trunc(torch.floor(coord[..., 0]))
    sy = _trunc(torch.floor(coord[..., 2]))

    # neighbour k = dx + 2 dy, as vkr_tpu's loop visits them
    k = torch.arange(4 if gs > 1 else 1, dtype=torch.int32, device=dev)
    gx = sx + (k & 1)[:, None, None]
    gy = sy + ((k >> 1) & 1)[:, None, None]
    probe_idx = (gy * gs + gx).clamp(0, gs * gs - 1)
    cell = torch.stack([gx.float(), torch.zeros_like(gx, dtype=torch.float32),
                        gy.float()], -1)
    origin = world_pos - (grid.probe_min + cell * pstep)   # (N, H, W, 3)
    bounds = _segments(origin, _inv_dir(r), 1e-6, 30.0)
    t0 = torch.stack(bounds[:4], 1)                        # (N, 4, H, W)
    t1 = torch.stack(bounds[1:], 1)
    seg_ok = (t1 - t0).abs() >= 0.002
    tables = _mip_tables(grid)
    res, hit_uv = _trace_segment(grid, tables, probe_idx[:, None],
                                 origin[:, None], r, t0, t1)
    color = _sample_probe_color(grid, probe_idx[:, None], hit_uv)

    # the first (neighbour, segment) that hits (1) or cannot tell (2)
    # settles the pixel; only a hit colours it
    code = torch.where(seg_ok, res, 0).reshape(-1, h, w)
    settles = (code > 0).to(torch.int32)
    first = settles.argmax(0, keepdim=True)
    hit = (settles.amax(0) > 0) & (code.gather(0, first)[0] == 1)
    rgb = color.reshape(-1, h, w, 3).gather(
        0, first[..., None].expand(1, h, w, 3))[0]
    reflection = torch.where(hit[..., None],
                             torch.cat([rgb, torch.ones_like(rgb[..., :1])],
                                       -1), 0.0)
    return torch.where((depth >= 1.0)[..., None], 0.0, reflection)


def _sample_probe_color(grid: ProbeGrid, probe_idx, uv):
    """Bilinear sample of (P, S, S, 3) with per-pixel probe index."""
    p, s, _, c = grid.colors.shape
    flat = grid.colors.reshape(p * s * s, c)
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = _trunc(x0)
    y0 = _trunc(y0)
    base = probe_idx.clamp(0, p - 1) * (s * s)

    def tap(xi, yi):
        return flat[(base + yi.clamp(0, s - 1) * s
                     + xi.clamp(0, s - 1)).long()]

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy
