"""The SSR hierarchical hi-Z march, and its plain PyTorch version.

One CUDA kernel (csrc/ssr_march.cu: one ray per lane, each warp taking
8x4 patches of rays from a global counter) replaces vkr_tpu's two Pallas
kernels: K2 `_phase_a_kernel` (vkr_tpu/passes/ssr_march.py:149,
iterations 0-15 at mip 0) and K3 `_phase_b_kernel` (:368, the hierarchical
iterations with compaction), both behind `hierarchical_march_pallas`
(:887). It ports the math of `_hierarchical_march`'s body
(vkr_tpu/passes/ssr.py:456-524, trace.comp:171-236 find_hor and
screen_trace.glsl:17-101), not the TPU blocks: no mip-0 window or
ring-shell prefetch, no one-hot MXU gathers, no compaction. A ray marches
until it is done or reaches max_iterations, and no ray is dropped, so the
march equals vkr_tpu's no-drop oracle `_hierarchical_march(...,
compact_frac=0.0)` up to float32 rounding, not its dropping Pallas path.

Arithmetic shared by the kernel and the plain version (they agree bit for
bit on the card): every product and sum rounded on its own (-fmad=false);
a Python scalar divided by a tensor as reciprocal-then-multiply (what
PyTorch does); vector lengths and dot products summed (x + y) + z; 2^-mip
built exactly; and a fetch index truncated toward zero after clamping the
float to [-1, 2^24] (a saturating cast: -0.3 texel fetches texel 0).

The plain hierarchical march without the horizon (hierarchical_march_plain,
what simple_ssr and ssr_trace_indirect run) is the same loop without the
mip-0 prefix and the horizon, from a chosen finest mip. vkr_tpu computes it
in jnp, so it has no kernel: PyTorch ops on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vkr_ref import kernels
from vkr_ref.core.constants import constant

MAX_T = 3.402823466e38
MAX_LEVELS = 16       # level table size of the CUDA kernel
FIND_HOR_PREFIX = 15  # iterations 0..14 stay at mip 0 (trace.comp find_hor)


def _pyramid(mips):
    """A FlatPyramid, or the list of levels packed into one. Read by its
    fields: registry.reload() re-executes ssr.py, and a pyramid made
    before a reload is an instance of the class it replaced."""
    from vkr_ref.passes.ssr import pack_pyramid

    return mips if hasattr(mips, "flat") else pack_pyramid(mips)


def _constants(params):
    """Per-frame float32 constants of reconstruct_view_vec: (tan(fovy/2),
    aspect, znear*zfar, zfar - znear, zfar), rounded as the plain passes
    round their Python scalars."""
    from vkr_ref.mathlib.projection import _tan_half

    return tuple(float(np.float32(v)) for v in (
        _tan_half(params.fovy), params.aspect, params.znear * params.zfar,
        params.zfar - params.znear, params.zfar))


def hierarchical_march(mips, origin, direction, camera_start, w0, params,
                       max_iterations: int):
    """The SSR hi-Z march (find_hor) over the depth pyramid.

    mips: the hi-Z pyramid, as ssr.FlatPyramid or the list of its (h_l,
    w_l) levels; origin/direction: (h, w, 3) projective ray start and
    direction; camera_start: (h, w, 3) view-space ray origin; w0: (h, w, 3)
    unit direction to the eye; params: fovy, aspect, znear, zfar.

    Returns (position (h, w, 3), hor (h, w), iters (h, w) int32) as
    vkr_tpu's hierarchical_march_pallas does: iters is max_iterations + 1
    for a ray that did not end in a hit (still marching at the cap, or
    retired out of bounds).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    pyr = _pyramid(mips)
    if True:  # frozen copy: the plain version on every device
        return hierarchical_march_reference(pyr, origin, direction,
                                            camera_start, w0, params,
                                            max_iterations)
    if not origin.is_cuda:
        raise ValueError(f"hierarchical_march: unsupported device "
                         f"{origin.device}")
    lead = origin.shape[:-1]
    n_levels = len(pyr.offsets)
    if int(max_iterations) - FIND_HOR_PREFIX >= 127:
        raise ValueError("hierarchical_march: the kernel builds 2^-mip from "
                         f"its bits, mip < 127; max_iterations "
                         f"{max_iterations} allows more")
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"hierarchical_march: {n_levels} levels, the "
                         f"kernel takes 1..{MAX_LEVELS}")
    for name, t in (("origin", origin), ("direction", direction),
                    ("camera_start", camera_start), ("w0", w0),
                    ("pyramid", pyr.flat)):
        if t.device != origin.device or t.dtype != torch.float32:
            raise ValueError(f"hierarchical_march: {name} must be float32 "
                             f"on {origin.device}, got {t.dtype} on "
                             f"{t.device}")
        if name != "pyramid" and tuple(t.shape) != tuple(lead) + (3,):
            raise ValueError(f"hierarchical_march: {name} shape "
                             f"{tuple(t.shape)} != {tuple(lead) + (3,)}")
    rays = [t.contiguous() for t in (origin, direction, camera_start, w0)]
    flat = pyr.flat.contiguous()
    # the level table goes to the kernel by value: no host-to-device copy
    levels = (ctypes.c_int * (3 * n_levels))(*pyr.offsets, *pyr.widths,
                                              *pyr.heights)
    n = int(np.prod(lead))
    ray_w = int(lead[-1]) if len(lead) and n else 1
    position = torch.empty(tuple(lead) + (3,), dtype=torch.float32,
                           device=origin.device)
    hor = torch.empty(tuple(lead), dtype=torch.float32, device=origin.device)
    iters = torch.empty(tuple(lead), dtype=torch.int32, device=origin.device)
    counter = torch.empty(1, dtype=torch.int32, device=origin.device)
    tg, aspect, k_nf, k_fn, zfar = _constants(params)
    err = kernels.library("ssr_march").vkr_ssr_march(
        *(t.data_ptr() for t in rays), n // ray_w, ray_w, flat.data_ptr(),
        levels, n_levels, pyr.widths[0], pyr.heights[0],
        tg, aspect, k_nf, k_fn, zfar, int(max_iterations),
        position.data_ptr(), hor.data_ptr(), iters.data_ptr(),
        counter.data_ptr(),
        torch.cuda.current_stream(origin.device).cuda_stream)
    kernels.check(err, "hierarchical_march")
    kernels.LAUNCHES["hierarchical_march"] += 1
    return position, hor, iters


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def hierarchical_march_plain(mips, origin, direction, max_iterations: int,
                             most_detailed_mip: int = 0):
    """The plain hierarchical hi-Z march (screen_trace.glsl:51-101), the
    form simple_ssr and ssr_trace_indirect run: vkr_tpu's
    `_hierarchical_march(..., find_hor=False, compact_frac=0.0)`, with no
    mip-0 prefix and no horizon, starting at `most_detailed_mip`
    (trace_indirect.comp:101 starts glossy rays at mip 1). PyTorch ops on
    any device: vkr_tpu computes it in jnp, so no TPU kernel stands behind
    it. Returns (position (h, w, 3), iters (h, w) int32), iters
    max_iterations + 1 for a ray that did not end in a hit."""
    position, _, iters = hierarchical_march_reference(
        mips, origin, direction, None, None, None, max_iterations,
        find_hor=False, most_detailed_mip=most_detailed_mip)
    return position, iters


def hierarchical_march_reference(mips, origin, direction, camera_start, w0,
                                 params, max_iterations: int,
                                 return_steps: bool = False,
                                 find_hor: bool = True,
                                 most_detailed_mip: int = 0):
    """Plain version of hierarchical_march (same arguments and results, any
    device): vkr_tpu's `_hierarchical_march` with compact_frac=0.0 as one
    loop to max_iterations. A done ray's state never changes, so running
    every iteration under masks gives what an early exit gives, with no
    host synchronisation. return_steps adds a fourth result: the
    iterations each ray ran before it was done (the kernel's loop count,
    which a roofline bound counts). find_hor=False is the plain march
    (hierarchical_march_plain): no prefix, no horizon (hor stays 0, and
    camera_start, w0 and params are not read), the finest mip
    most_detailed_mip."""
    from vkr_ref.passes.ssr import fetch_pyramid

    pyr = _pyramid(mips)
    dev = origin.device
    n_levels = len(pyr.offsets)
    w, h = pyr.widths[0], pyr.heights[0]
    if find_hor:
        tg, aspect, k_nf, k_fn, zfar = _constants(params)
    screen = constant([w, h], dev)
    top = int(most_detailed_mip)

    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    inv_dir = torch.where(direction != 0.0,
                          1.0 / torch.where(direction == 0.0, 1.0, direction),
                          MAX_T)
    # 0.005 * exp2(most_detailed_mip) / screen (screen_trace.glsl:71)
    uv_offset_mag = (0.005 * 2.0 ** top) / screen
    uv_offset = torch.where(direction[..., :2] < 0, -uv_offset_mag,
                            uv_offset_mag)
    floor_offset = torch.where(direction[..., :2] < 0, 0.0, 1.0)

    # initial_advance_ray (screen_trace.glsl:8-15) at most_detailed_mip
    start_res = screen * 2.0 ** -top
    xy_plane = (torch.floor(start_res * origin[..., :2]) + floor_offset) \
        / start_res + uv_offset
    t0 = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
    current_t = torch.minimum(t0[..., 0], t0[..., 1])
    position = origin + current_t[..., None] * direction

    lead = origin.shape[:-1]
    mip = torch.full(lead, top, dtype=torch.int32, device=dev)
    hor = torch.zeros(lead, dtype=torch.float32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    iters = torch.zeros(lead, dtype=torch.int32, device=dev)
    oob = torch.zeros(lead, dtype=torch.bool, device=dev)

    for i in range(max_iterations):
        # 2^-mip, exactly: the float32 bit pattern with exponent 127 - mip
        scale = ((127 - mip) << 23).view(torch.float32)
        mip_res = screen * scale[..., None]
        mip_pos = mip_res * position[..., :2]
        idx = mip_pos.clamp(-1.0, 16777216.0).to(torch.int32)
        surface_z = fetch_pyramid(pyr, mip.clamp(0, n_levels - 1),
                                  idx[..., 0], idx[..., 1])

        # advance_ray (screen_trace.glsl:17-45)
        xy_plane = (torch.floor(mip_pos) + floor_offset) / mip_res + uv_offset
        t_xy = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
        t_z = torch.where(dz > 0, (surface_z - oz) * inv_dir[..., 2], MAX_T)
        t_min = torch.minimum(torch.minimum(t_xy[..., 0], t_xy[..., 1]), t_z)
        above = surface_z > position[..., 2]
        skipped = (t_min != t_z) & above
        new_t = torch.where(above, t_min, current_t).clamp(-1e20, 1e20)
        new_pos = origin + new_t[..., None] * direction
        if find_hor and i < FIND_HOR_PREFIX:
            new_mip = mip
        else:
            new_mip = mip + torch.where(skipped, 1, -1).to(torch.int32)

        act = ~done
        position = torch.where(act[..., None], new_pos, position)
        current_t = torch.where(act, new_t, current_t)
        mip = torch.where(act, new_mip, mip)

        if find_hor:
            # horizon estimate on fine mips (trace.comp:214-223):
            # reconstruct_view_vec(position.xy, surface_z) - camera_start
            z = k_nf / (surface_z * k_fn - zfar)
            vx = -(2.0 * position[..., 0] - 1.0) * ((z * aspect) * tg)
            vy = -(2.0 * position[..., 1] - 1.0) * (z * tg)
            v = torch.stack([vx, vy, z], -1) - camera_start
            v_len = torch.sqrt(_dot3(v, v)).clamp(min=1e-20)
            h2 = _dot3(w0, v / v_len[..., None])
            hor_upd = act & (mip <= 1) & (v_len < 0.3)
            hor = torch.where(hor_upd, torch.maximum(hor, h2), hor)

        iters = torch.where(act, i + 1, iters)
        done = done | (mip < top)
        # a ray outside the screen moving further out never intersects
        # again: it retires as invalid
        px, py = position[..., 0], position[..., 1]
        out = (((px < 0.0) & (dx <= 0.0)) | ((px > 1.0) & (dx >= 0.0))
               | ((py < 0.0) & (dy <= 0.0)) | ((py > 1.0) & (dy >= 0.0)))
        newly_oob = act & out & (mip >= 0)
        done = done | newly_oob
        oob = oob | newly_oob

    steps = iters
    iters = torch.where(done & ~oob, iters, max_iterations + 1)
    position = torch.where(torch.isfinite(position), position, 0.0)
    out = (position.clamp(-1e6, 1e6), hor, iters.to(torch.int32))
    return out + (steps,) if return_steps else out
