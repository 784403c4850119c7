"""Stochastic hi-Z screen-space reflections (SSSR), half resolution.

Reference: src/advanced_ssr.cpp + shaders/advanced_ssr/{trace,filter,blur,
preintegrate,preintegrate_ssr}.comp; vkr_tpu/passes/ssr.py. Chain
(advanced_ssr.cpp run()):
  trace  — GGX VNDF importance sample (halton-indexed), reflect, then the
           hierarchical hi-Z march over the depth mip pyramid (ssr_march.py,
           the CUDA kernel that replaces vkr_tpu's K2+K3) with an AO-style
           occlusion estimate tracked on fine mips
  filter — cross-shaped 5-tap resolve weighting neighbor rays by this
           pixel's BRDF (F * G2/G1), depth-bilateral
  blur   — roughness-adaptive gaussian with depth/normal bilateral weights
           + velocity-validated history reprojection (0.1 blend, K5)

Band mode (row0/band_h, parallel/band.py): each pass computes only the
half-res rows [row0, row0 + band_h) from full-frame inputs, bit for bit
those rows of its full call. The trace's Halton and rand() rows, the
filter's uv and the blur's reprojection take global rows; the filter's
and the blur's halos replicate the frame's edges, not the band's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vkr_tpu_torch.core.constants import constant
from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.brdf import (
    brdf_g1,
    brdf_g2,
    f0_approximation,
    fresnel_schlick,
    halton23_table,
    sample_ggx_vndf,
)
from vkr_tpu_torch.mathlib.octahedral import decode_normal
from vkr_tpu_torch.mathlib.projection import (
    linearize_depth,
    project_view_vec,
    reconstruct_view_vec,
)
from vkr_tpu_torch.passes.sampling import (
    band_slice,
    bilinear_from_quad,
    downsample_full_to_half,
    downsample_full_to_half_corner,
    quad_pack,
    reproject_bilinear,
    screen_uv_grid,
)
from vkr_tpu_torch.passes import ssr_blur_kernel
# vkr_tpu's names here (ssr.py:45, :780); R2's module and the march
# define them
from vkr_tpu_torch.passes.ssr_blur_kernel import MAX_BLUR_RADIUS  # noqa: F401
from vkr_tpu_torch.passes.ssr_march import MAX_T  # noqa: F401

PI = math.pi
HALTON_SEQ_SIZE = 128  # advanced_ssr.cpp:6
CUDA = torch.device("cuda")


class SSRParams(NamedTuple):
    normal_mat: torch.Tensor  # (4,4) world->view normal matrix
    fovy: float
    aspect: float
    znear: float
    zfar: float
    max_roughness: float = 1.0


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _unit(v):
    return v / _norm(v, True).clamp(min=1e-20)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------- LUTs

@register("pdf_preintegrate")
def preintegrate_pdf(size: int = 1024, steps: int = 2000, device=CUDA):
    """GGX direction-PDF LUT (preintegrate.comp, G2 variant): integrate
    (1-t)L / (1 + t^2 - L^2/2)^2, L = (b-a)t + (b+a), t in [-1, 1].
    Returns (size, size) float32 on `device`.

    Near the denominator's zero one ulp of it moves a term by orders of
    magnitude, so the steps follow vkr_tpu's jitted loop, which contracts
    t = fma(2/steps, i + 0.5, -1), L = fma(p, t, q) and den = fma(-L/2, L,
    fma(t, t, 1)): each is an exact float64 product and sum rounded once
    to float32. Rounded step by step, texel (63, 36) of the 64² LUT
    overflows to +inf where vkr_tpu's is finite."""
    f32 = dict(dtype=torch.float32, device=device)
    px = (torch.arange(size, **f32) + 0.5) / size
    a = (2.0 * px - 1.0)[None, :]
    b = px[:, None]
    p = (b - a).double()
    q = (b + a).double()
    acc = torch.zeros((size, size), **f32)
    f, d = np.float32, np.float64
    for i in range(steps):
        t = f(d(f(2.0 / steps)) * d(f(i) + f(0.5)) - 1.0)
        big_l = (p * float(t) + q).float()
        nom = float(f(1.0) - t) * big_l
        den = (-(0.5 * big_l).double() * big_l.double()
               + float(f(d(t) * d(t) + 1.0))).float()
        g = torch.where(big_l > 0.0, nom / (den * den), 0.0)
        acc = acc + g
    return 2.0 / steps * acc


@register("brdf_preintegrate")
def preintegrate_brdf(size: int = 1024, num_samples: int = 128,
                      device=CUDA):
    """Split-sum environment BRDF LUT (preintegrate_ssr.comp): x =
    roughness, y = NdotV -> (A, B) with reflection = F0*A + B.
    Returns (size, size, 2) float32 on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    px = (torch.arange(size, **f32) + 0.5) / size
    roughness = px[None, :]
    ndv = px[:, None]
    ones = torch.ones_like(roughness)
    r2 = roughness * roughness
    v = torch.stack(
        [torch.sqrt(torch.clamp(1.0 - ndv * ndv, min=0.0)) * ones,
         torch.zeros((size, size), **f32),
         ndv * ones], dim=-1,
    )
    samples = torch.as_tensor(halton23_table(num_samples), **f32)

    a_sum = torch.zeros((size, size), **f32)
    b_sum = torch.zeros((size, size), **f32)
    g1 = brdf_g1(r2, ndv * ones)
    for i in range(num_samples):
        h = sample_ggx_vndf(v, r2, r2, samples[i, 0], samples[i, 1])
        # reflect(-V, H) = -V + 2*dot(V,H)*H
        vdh = (v * h).sum(-1)
        l = -v + 2.0 * vdh[..., None] * h
        l = _unit(l)
        ndl = l[..., 2]
        alpha = (1.0 - vdh) ** 5
        g2 = brdf_g2(ndv * ones, ndl, r2)
        ratio = g2 / torch.clamp(g1, min=1e-20)
        a_sum = a_sum + ratio * (1.0 - alpha)
        b_sum = b_sum + ratio * alpha
    return torch.stack([a_sum / num_samples, b_sum / num_samples], dim=-1)


def sample_ggx_dir_pdf(pdf_lut, w0, n, l, alpha):
    """sampleGGXdirPDF (brdf.glsl:104-127): LUT lookup form of the VNDF
    direction pdf."""
    y = _unit(_cross(w0, n))
    x = _unit(_cross(y, w0))
    alpha = alpha.clamp(0.0, 0.9)

    l_proj = _unit(l - w0 * (w0 * l).sum(-1, keepdim=True))
    cos_theta = (x * l_proj).sum(-1)
    cos_phin = (n * x).sum(-1)
    sin_phin = torch.sqrt(torch.clamp(1.0 - cos_phin * cos_phin, min=0.0))

    alpha2 = alpha * alpha
    coef = torch.sqrt(torch.clamp(1.0 - alpha2, min=1e-20))
    a = 0.5 * coef * cos_phin * cos_theta + 0.5
    b = coef * sin_phin
    lut = bilinear_from_quad(quad_pack(pdf_lut), 1,
                             torch.stack([a, b], dim=-1))[..., 0]
    return alpha2 / (2.0 * PI * coef) * lut


# ------------------------------------------------------- flat pyramid

class FlatPyramid(NamedTuple):
    """Depth mip pyramid packed into one flat tensor; the march kernel
    takes it with its per-level offsets, heights and widths as they are."""

    flat: torch.Tensor          # (sum h_l*w_l,) f32
    offsets: Tuple[int, ...]    # per-level start
    heights: Tuple[int, ...]
    widths: Tuple[int, ...]


def pack_pyramid(mips) -> FlatPyramid:
    offsets = []
    off = 0
    for m in mips:
        offsets.append(off)
        off += m.shape[0] * m.shape[1]
    return FlatPyramid(
        flat=torch.cat([m.reshape(-1) for m in mips]),
        offsets=tuple(offsets),
        heights=tuple(int(m.shape[0]) for m in mips),
        widths=tuple(int(m.shape[1]) for m in mips),
    )


def fetch_pyramid(pyr: FlatPyramid, mip, x, y):
    """texelFetch(depth, ivec2(x, y), mip) with a per-pixel mip (vkr_tpu
    ssr.py:184): x clamped to [0, w_mip - 1] and y to [0, h_mip - 1], then
    flat[offset_mip + y * w_mip + x]. mip, x, y: integer tensors of one
    shape. The level's offset, width and height come from small tables
    indexed by mip; a mip outside [0, levels) reads level 0's, as
    vkr_tpu's where-chain over the levels does."""
    lvl = constant([pyr.offsets, pyr.widths, pyr.heights], pyr.flat.device,
                   torch.int64)
    m = torch.where((mip >= 0) & (mip < len(pyr.offsets)), mip, 0).long()
    off, w, h = lvl[0][m], lvl[1][m], lvl[2][m]
    xi = torch.minimum(x.long().clamp(min=0), w - 1)
    yi = torch.minimum(y.long().clamp(min=0), h - 1)
    return pyr.flat[off + yi * w + xi]


# ------------------------------------------------------------- trace

def _get_tangent(n):
    """main.comp get_tangent."""
    max_xy = torch.maximum(n[..., 0].abs(), n[..., 1].abs())
    x_axis = constant([1.0, 0.0, 0.0], n.device, n.dtype)
    t = torch.where((max_xy < 1e-5)[..., None], x_axis.expand(n.shape),
                    torch.stack([n[..., 1], -n[..., 0],
                                 torch.zeros_like(max_xy)], -1))
    return _unit(t)


_RAND_A = float(np.float32(12.9898))


def _shader_rand(uv):
    """trace.comp rand(): fract(sin(dot(uv, (12.9898, 78.233))) * 43758.5453).

    The product by 43758.5453 turns a last-ulp difference of sin or of its
    argument into a different halton row, so both are pinned: the dot is
    one fma, fma(u, 12.9898, v * 78.233) — what XLA's jit and shader
    compilers make of it — computed exactly in float64 and rounded once,
    and sin is taken in float64 and rounded once, so the row does not
    hang on a device's float32 sin."""
    arg = (uv[..., 0].double() * _RAND_A
           + (uv[..., 1] * 78.233).double()).float()
    s = torch.sin(arg.double()).float() * 43758.5453
    return s - torch.floor(s)


def _halton_index(uv, frame_random):
    """Per-pixel halton row: (uint(rand(uv) * 128) + frame_random) & 127.
    rand * 128 lies in [0, 128), so truncation to int64 is the uint cast.
    frame_random: an int, or the frame's 0-d int32 tensor on the device."""
    base = (_shader_rand(uv) * HALTON_SEQ_SIZE).to(torch.int64)
    return (base + frame_random) & (HALTON_SEQ_SIZE - 1)


def _reflection_ray_setup(uv, pixel_depth, normal_half, roughness, params,
                          frame_random, halton):
    """Per-pixel reflection ray construction (trace.comp:47-93): GGX-VNDF
    microfacet normal from the halton pair, R = reflect(view_vec, N),
    projective ray start/dir. Returns (view_vec, w0, camera normal n,
    reflection dir r, ray_start, ray_dir)."""
    nm = params.normal_mat
    n = _unit(decode_normal(normal_half) @ nm[:3, :3].T)
    view_vec = reconstruct_view_vec(uv, pixel_depth, params.fovy,
                                    params.aspect, params.znear, params.zfar)
    rnd = halton[_halton_index(uv, frame_random)]

    tangent = _get_tangent(n)
    bitangent = _unit(_cross(n, tangent))
    tangent = _unit(_cross(bitangent, n))

    w0 = -view_vec / _norm(view_vec, True).clamp(min=1e-20)
    vd = torch.stack([(w0 * tangent).sum(-1), (w0 * bitangent).sum(-1),
                      (w0 * n).sum(-1)], -1)
    brdf_n = sample_ggx_vndf(vd, roughness, roughness, rnd[..., 0],
                             rnd[..., 1])
    big_n = (brdf_n[..., 0:1] * tangent + brdf_n[..., 1:2] * bitangent
             + brdf_n[..., 2:3] * n)
    # R = reflect(view_vec, N)
    r = view_vec - 2.0 * (view_vec * big_n).sum(-1, keepdim=True) * big_n

    ray_start = project_view_vec(view_vec + 0.001 * n, params.fovy,
                                 params.aspect, params.znear, params.zfar)
    ray_start = torch.cat([ray_start[..., :2],
                           ray_start[..., 2:] + (-0.0001)], -1)
    ray_dir = project_view_vec(view_vec + r, params.fovy, params.aspect,
                               params.znear, params.zfar) - ray_start
    dz = ray_dir[..., 2]
    scale = (1.0 - ray_start[..., 2]) / torch.where(dz.abs() < 1e-20, 1e-20,
                                                    dz)
    ray_dir = ray_dir * scale[..., None]
    return view_vec, w0, n, r, ray_start, ray_dir


@register("sssr_trace")
def ssr_trace(hiz: FlatPyramid, normal_half, material_full, pdf_lut,
              params: SSRParams, frame_random, halton,
              max_iterations: int = 80, use_kernel: bool = True,
              row0: "int | None" = None, band_h: "int | None" = None):
    """trace.comp main(): returns (ray_info (h, w, 4) = hit uvz + src depth
    [1.0 = invalid], occlusion (h, w, 2) = AO estimate + pdf).

    The march is ssr_march.hierarchical_march: the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor or with use_kernel=False.
    Unlike vkr_tpu's Pallas march it drops no ray (no compaction, no
    phase-A shell retire).

    row0/band_h (band mode, vkr_tpu ssr.py:277): trace only the rows
    [row0, row0 + band_h); the pyramid, normals and material stay whole
    (the march and the hit validation fetch anywhere)."""
    from vkr_tpu_torch.passes import ssr_march

    march = (ssr_march.hierarchical_march if use_kernel
             else ssr_march.hierarchical_march_reference)

    h, w = hiz.heights[0], hiz.widths[0]
    bh = h if row0 is None else band_h
    dev = hiz.flat.device
    uv = screen_uv_grid(bh, w, dev, row0=row0 or 0, full_height=h)
    size = constant([w, h], dev)
    depth_full = hiz.flat[: h * w].reshape(h, w)
    pixel_depth = band_slice(depth_full, row0, bh)

    material = band_slice(downsample_full_to_half(material_full)[:h, :w],
                          row0, bh)
    biased = params.max_roughness * material[..., 1]
    roughness = biased * biased  # alpha

    view_vec, w0, n, r, ray_start, ray_dir = _reflection_ray_setup(
        uv, pixel_depth, band_slice(normal_half, row0, bh), roughness, params,
        frame_random, halton)
    position, hor, iters = march(
        hiz, ray_start, ray_dir, view_vec, w0, params, max_iterations)
    valid_hit = iters <= max_iterations

    # Post-march validation (trace.comp:97-122)
    ray_step = (position[..., :2] - ray_start[..., :2]).abs() * size
    valid_hit = valid_hit & (torch.maximum(ray_step[..., 0],
                                           ray_step[..., 1]) >= 2.0)
    nm = params.normal_mat
    hit_n = decode_normal(bilinear_from_quad(
        quad_pack(normal_half), 2, position[..., :2])) @ nm[:3, :3].T
    valid_hit = valid_hit & ~(((hit_n * r).sum(-1) > 0)
                              | ((n * r).sum(-1) < 0))

    # textureLod(DEPTH, xy, 0) = bilinear on the half-res base mip
    hit_depth = bilinear_from_quad(quad_pack(depth_full), 1,
                                   position[..., :2])[..., 0]
    hit_z = linearize_depth(hit_depth, params.znear, params.zfar)
    ray_z = linearize_depth(position[..., 2], params.znear, params.zfar)
    valid_hit = valid_hit & ~((ray_z > hit_z + 0.3) | (ray_z < hit_z - 0.1))

    ray_info = torch.cat(
        [position, torch.where(valid_hit, pixel_depth, 1.0)[..., None]], -1)

    # occlusion estimate (trace.comp:126-146)
    slice_n = _unit(_cross(w0, r))
    n_proj = n - (n * slice_n).sum(-1, keepdim=True) * slice_n
    n_len = _norm(n_proj).clamp(min=1e-20)
    x_axis = _unit(_cross(slice_n, w0))
    n_ang = PI / 2.0 - torch.arccos(
        ((n_proj / n_len[..., None]) * x_axis).sum(-1).clamp(-1.0, 1.0))
    no_occlusion = hor == -1.0
    hh = torch.arccos(hor.clamp(-1.0, 1.0))
    hh = torch.minimum(n_ang + torch.clamp(hh - n_ang, max=PI / 2.0), hh)
    pdf = sample_ggx_dir_pdf(pdf_lut, w0, n, r, roughness)
    occl = (1.0 / PI) * n_len * 0.25 * torch.clamp(
        -torch.cos(2 * hh - n_ang) + torch.cos(n_ang)
        + 2 * hh * torch.sin(n_ang), min=0.0)
    occl = torch.where(torch.isnan(occl), 0.0, occl)
    occlusion = torch.stack([torch.where(no_occlusion, 0.0, occl),
                             torch.where(no_occlusion, 0.0, pdf)], -1)
    return ray_info, occlusion


# ------------------------------------------------------------- filter

def _pad_edge(a, dim: int, pad: int):
    """Replicate a's edge `pad` times on both ends of `dim`."""
    n = a.shape[dim]
    idx = (torch.arange(n + 2 * pad, device=a.device) - pad).clamp(0, n - 1)
    return a.index_select(dim, idx)


def _ray_weight(n, v, l, f0, roughness):
    """filter.comp ray_weight: F * G2 / G1 (note the reference passes
    (NdotL, NdotV) into brdfG2's (NdotV, NdotL) slots — kept)."""
    hv = _unit(v + l)
    f = fresnel_schlick(torch.clamp((hv * v).sum(-1), min=0.0)[..., None],
                        f0)
    alpha2 = roughness * roughness
    ndl = torch.clamp((n * l).sum(-1), min=0.0)
    ndv = torch.clamp((n * v).sum(-1), min=0.0)
    g2 = brdf_g2(ndl, ndv, alpha2)
    g1 = brdf_g1(alpha2, ndv)
    return f * (g2 / torch.clamp(g1, min=1e-20))[..., None]


@register("sssr_filter")
def ssr_filter(rays, depth_half, albedo_full, normal_half, material_full,
               params: SSRParams, flags_normalize: bool = True,
               flags_bilateral: bool = True, row0: "int | None" = None,
               band_h: "int | None" = None):
    """filter.comp: 5-tap cross resolve, BRDF-weighted. Returns (h, w, 3).

    Each tap samples radiance at the NEIGHBOR ray's hit uv, which is the
    value the center tap computes at that neighbor pixel: the radiance is
    gathered once per pixel and shifted, as vkr_tpu does.

    row0/band_h (band mode, vkr_tpu ssr.py:647): rows [row0, row0 +
    band_h) from the whole frame's rays and planes, with a one-row halo
    that replicates the frame's edges (ssr.py:700-705). The cross's uv
    step is one row of the frame, 1/H; vkr_tpu's band form divides by the
    band's height there (ssr.py:735), which changes every tap's view
    vector (ROADMAP queue 3)."""
    H, w = depth_half.shape
    h = H if row0 is None else band_h
    r0 = row0 or 0
    dev = depth_half.device
    f32 = dict(dtype=torch.float32, device=dev)
    # NOTE: filter.comp uses uv = pixel/tex_size (no half-texel!)
    vv, uu = torch.meshgrid(torch.arange(r0, r0 + h, **f32) / H,
                            torch.arange(w, **f32) / w, indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)

    material = band_slice(
        downsample_full_to_half_corner(material_full)[:H, :w], row0, h)
    metallic = material[..., 2]
    roughness = material[..., 1]
    albedo = band_slice(
        downsample_full_to_half_corner(albedo_full[..., :3])[:H, :w], row0,
        h)
    f0 = f0_approximation(albedo, metallic)
    nm = params.normal_mat
    center_depth = band_slice(depth_half, row0, h)

    pad = 1

    def halo_rows(a):
        # rows [r0 - pad, r0 + h + pad), the frame's edges replicated
        return _pad_edge(a, 0, pad)[r0:r0 + h + 2 * pad]

    rays_h = halo_rows(rays)
    radiance_h = torch.where(
        (rays_h[..., 3] != 1.0)[..., None],
        bilinear_from_quad(quad_pack(albedo_full[..., :3]), 3,
                           rays_h[..., :2]), 0.0)
    rays_p = _pad_edge(rays_h, 1, pad)
    rad_p = _pad_edge(radiance_h, 1, pad)
    depth_p = _pad_edge(halo_rows(depth_half), 1, pad)
    normal_p = _pad_edge(halo_rows(normal_half), 1, pad)

    color_sum = torch.zeros((h, w, 3), **f32)
    weight_sum = torch.zeros((h, w, 3), **f32)
    offsets = ([(0, 0), (-1, 0), (0, 1), (1, 0), (0, -1)]
               if flags_normalize else [(0, 0)])
    for dx, dy in offsets:
        rows = slice(pad + dy, pad + dy + h)
        cols = slice(pad + dx, pad + dx + w)
        tr = rays_p[rows, cols]
        p_depth = depth_p[rows, cols]
        p_uv = uv + constant([dx / w, dy / H], dev)
        view_vec = reconstruct_view_vec(p_uv, p_depth, params.fovy,
                                        params.aspect, params.znear,
                                        params.zfar)
        p_normal = decode_normal(normal_p[rows, cols]) @ nm[:3, :3].T
        hit_vec = reconstruct_view_vec(tr[..., :2], tr[..., 2], params.fovy,
                                       params.aspect, params.znear,
                                       params.zfar)
        v = -view_vec / _norm(view_vec, True).clamp(min=1e-20)
        l = _unit(hit_vec - view_vec)
        weight = _ray_weight(p_normal, v, l, f0, roughness)
        if flags_bilateral:
            bw = torch.clamp(1.0 - 1000.0 * (center_depth - p_depth).abs()
                             / center_depth.abs().clamp(min=1e-20), min=0.0)
            weight = weight * bw[..., None]
        color_sum = color_sum + weight * rad_p[rows, cols]
        weight_sum = weight_sum + weight

    wmax = weight_sum.amax(dim=-1, keepdim=True)
    weight_sum = torch.where(wmax < 0.001, 1.0, weight_sum)
    return color_sum / weight_sum


# --------------------------------------------------------------- blur

class SSRBlurParams(NamedTuple):
    inverse_camera: torch.Tensor
    prev_inverse_camera: torch.Tensor
    fovy: float
    aspect: float
    znear: float
    zfar: float
    max_roughness: float = 1.0
    accumulate: bool = True
    disable_blur: bool = False


@register("sssr_blur")
def ssr_blur(reflections, depth_half, normal_half, material_full, history,
             velocity_half, prev_depth_half, params: SSRBlurParams,
             use_kernel_gather: bool = True, row0: "int | None" = None,
             band_h: "int | None" = None):
    """blur.comp: per-pixel roughness-adaptive gaussian (sigma in
    [0.4, 4]) with depth/normal bilateral weights, then velocity-validated
    history blend (0.1). Returns (h, w, 3).

    The 23x23 bilateral gather is R2 (ssr_blur_kernel.ssr_blur,
    csrc/ssr_blur.cu on the card), which adds the 529 taps in vkr_tpu's
    fori_loop order; this pass computes its sigma plane and decodes the
    normals once for it. The gather and the reprojection go through R2
    and K5, or their plain versions with use_kernel_gather=False.

    row0/band_h (band mode, vkr_tpu ssr.py:786): rows [row0, row0 +
    band_h) from whole-frame inputs, with a MAX_BLUR_RADIUS halo that
    replicates the frame's edges; the reprojection reads the whole
    previous depth (K5 with row0)."""
    H, w = depth_half.shape
    h = H if row0 is None else band_h
    r0 = row0 or 0
    dev = depth_half.device
    uv = screen_uv_grid(h, w, dev, row0=r0, full_height=H)

    roughness = band_slice(
        downsample_full_to_half(material_full[..., 1])[:H, :w], row0, h)
    roughness = params.max_roughness * roughness
    sigma = 0.4 + (4.0 - 0.4) * roughness
    if params.disable_blur:
        sigma = torch.full_like(sigma, 0.35)
    blur = (ssr_blur_kernel.ssr_blur if use_kernel_gather
            else ssr_blur_kernel.ssr_blur_reference)
    color = blur(
        reflections.contiguous(), depth_half.contiguous(),
        decode_normal(normal_half).contiguous(), sigma.contiguous(),
        row0=r0)
    depth_c = band_slice(depth_half, row0, h)

    # history reprojection (blur.comp:82-106)
    velocity = band_slice(velocity_half, row0, h)
    prev_uv = uv + velocity
    in_b = ((prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
            & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1))

    def world(d, inv_cam, suv):
        vc = reconstruct_view_vec(suv, d, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        return vc @ inv_cam[:3, :3].T + inv_cam[:3, 3]

    w_cur = world(depth_c, params.inverse_camera, uv)
    w_prev = world(reproject_bilinear(prev_depth_half, velocity,
                                      use_kernel=use_kernel_gather, row0=r0),
                   params.prev_inverse_camera, prev_uv)
    cam = params.inverse_camera[:3, 3]
    err = _norm(w_cur - w_prev)
    pixel_dist = _norm(w_cur - cam)
    vlen = _norm(velocity)
    reprojected = in_b & ((vlen < 1e-4) | (
        err < torch.clamp(0.1 * pixel_dist * vlen, 0.01, 0.1)))
    if not params.accumulate:
        reprojected = torch.zeros_like(reprojected)

    # NOTE: blur.comp samples HISTORY_TEX at screen_uv (not prev_uv)
    history = band_slice(history, row0, h)
    return torch.where(reprojected[..., None],
                       history + (color - history) * 0.1, color)
