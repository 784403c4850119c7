"""A second, independent reference of the frame's image-space chain, in
plain PyTorch: hi-Z, the SSR filter and blur, probe GI (the octahedral
maps and depth pyramids from the probes' cube faces, the probe trace and
its composition into the SSR image), MIS GTAO and ray-traced GTAO (the
scene grid and its any-hit walk), the GTAO filter and temporal
accumulation, deferred shading and the TAA resolve, with the two LUTs
they read.

Written from vk-renderer's shaders as the JAX package `vkr_tpu` states
them (passes/downsample.py, ssr.py, probes.py, gtao.py, shading.py,
taa.py, sampling.py, frame.py, scene/accel.py, mathlib/), not from the
port: each pass is a direct
per-pixel formulation (one bilinear gather per tap, clamp-to-edge),
without the port's packed layouts, fused gathers or kernels. Three
places follow the JAX package's arithmetic where a rounding decides a
discrete choice: the 2x upsample's 0.25/0.75 blends, whose ties pick
the AO and reflection texel, the pdf table's fused multiply-adds near
its pole, and the probe march (its operations in their order, the
depth pyramids packed as it packs them), whose hits a rounding flips.

It judges a frame stage by stage. The SSR and GTAO stages start from
the judged frame's own G-buffer and the state carried into it (teacher
forcing); shading and TAA start from the frozen frame's G-buffer, AO
and SSR and the state the frozen side carried, since on the frame's own
products the control (TF32 products, which leave these passes' 3x3
products in float32) would not move them. So a pass of the chain that
departs from the shaders' semantics shows in the stage that holds it,
whatever the frozen frame does. Two stages it does not write again, and the
frozen frame alone judges: the raster (the G-buffer and the probes' cube
faces, which it takes from the frozen frame's grid), and the SSR
trace's hi-Z march, whose rays and occlusion estimate it takes from the
frozen frame rendered at the same camera and frame index. The march
leaves a ray that finds no surface wherever its last step ended, and
the filter weighs those positions: they are no semantics of the
shaders, and the port's, the JAX package's and a plain march's differ
on one pixel in ten.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
PI = math.pi
BRDF_PI = 3.1415926535897932384626433832795
GATHER_RADIUS = 16          # every reprojection gather clamps to +-16 px
GTAO_STEPS = 16
GTAO_THICKNESS = 0.1
BLUR_RADIUS = 11
LIGHT_POS = (-1.85867, 5.81832, -0.247114)
LIGHT_RADIANCE = (0.1, 0.1, 0.1)
ANGLE_OFFSETS = np.asarray([60.0, 300.0, 180.0, 240.0, 120.0, 0.0,
                            300.0, 60.0, 180.0, 120.0, 240.0, 0.0],
                           np.float32) / np.float32(360.0)


# ---------------------------------------------------------------- helpers

def _norm(v, eps=1e-20):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def _dot(a, b):
    return (a * b).sum(-1)


def pixel_centers(h, w, device):
    """(h, w, 2) uv at pixel centres."""
    ys = (torch.arange(h, dtype=F32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=F32, device=device) + 0.5) / w
    return torch.stack([xs.expand(h, w), ys[:, None].expand(h, w)], -1)


class Lens:
    """The projection's four numbers and the view-space reconstruction
    (gbuffer_encode.glsl)."""

    def __init__(self, fovy, aspect, znear, zfar):
        self.fovy, self.aspect = float(fovy), float(aspect)
        self.znear, self.zfar = float(znear), float(zfar)
        self.tg = math.tan(self.fovy / 2.0)

    def linear_z(self, d):
        return self.znear * self.zfar / (d * (self.zfar - self.znear)
                                         - self.zfar)

    def view_pos(self, uv, d):
        z = self.linear_z(d)
        x = -(2.0 * uv[..., 0] - 1.0) * (z * self.aspect * self.tg)
        y = -(2.0 * uv[..., 1] - 1.0) * (z * self.tg)
        return torch.stack([x, y, z], -1)


def decode_oct(e):
    """Octahedral RG payload in [0, 1]^2 -> unit normal."""
    p = 2.0 * e - 1.0
    z = 1.0 - p[..., 0].abs() - p[..., 1].abs()
    sign = torch.where(p >= 0.0, 1.0, -1.0)
    folded = (1.0 - p.flip(-1).abs()) * sign
    xy = torch.where((z < 0.0)[..., None], folded, p)
    return _norm(torch.cat([xy, z[..., None]], -1), 0.0)


def _bilinear(img, x0, y0, fx, fy, rows_first=False):
    """img's four texels around integer (x0, y0), clamped to the edge,
    weighted by the fractions (fx, fy): columns first (the sampler's
    order), or rows first (the reprojection gather's)."""
    flat = img.ndim == 2
    im = img[..., None] if flat else img
    H, W, C = im.shape
    rows = im.reshape(H * W, C)
    fx, fy = fx[..., None], fy[..., None]

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return rows[idx.reshape(-1)].reshape(*idx.shape, C)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    if rows_first:
        left = t00 + (t01 - t00) * fy
        right = t10 + (t11 - t10) * fy
        out = left + (right - left) * fx
    else:
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        out = top + (bot - top) * fy
    return out[..., 0] if flat else out


def sample(img, x, y):
    """Bilinear sample with clamp-to-edge at continuous texel coordinates
    (x, y), texel centres at integers. img (H, W) or (H, W, C)."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    return _bilinear(img, x0f.long(), y0f.long(), x - x0f, y - y0f)


def sample_uv(img, uv):
    """texture(img, uv) with a linear sampler, clamp-to-edge."""
    H, W = img.shape[:2]
    return sample(img, uv[..., 0] * W - 0.5, uv[..., 1] * H - 0.5)


def gather_offset(img, off_x, off_y, radius=GATHER_RADIUS):
    """The reprojection fetch: img at each output pixel's own texel moved
    by (off_x, off_y) pixels, each clamped to +-radius. The whole and
    fractional texels come from the offset alone, so the weights keep
    the offset's precision wherever the pixel lies."""
    h, w = off_x.shape[:2]
    ox, oy = off_x.clamp(-radius, radius), off_y.clamp(-radius, radius)
    sx, sy = torch.floor(ox), torch.floor(oy)
    ys = torch.arange(h, device=off_x.device)[:, None]
    xs = torch.arange(w, device=off_x.device)[None, :]
    return _bilinear(img, xs + sx.long(), ys + sy.long(), ox - sx, oy - sy,
                     rows_first=True)


def half_mean(img):
    """A full-res image sampled at half-res pixel centres: the 2x2 mean."""
    H, W = img.shape[:2]
    q = img[: H // 2 * 2, : W // 2 * 2]
    return q.reshape(H // 2, 2, W // 2, 2, *img.shape[2:]).mean(dim=(1, 3))


def half_corner(img):
    """A full-res image sampled at half-res uv = pixel / size (the SSR
    filter's convention): the mean of texels 2x-1 and 2x on each axis,
    clamped at the edge."""
    H, W = img.shape[:2]
    ys = torch.arange(0, H, 2, device=img.device)
    xs = torch.arange(0, W, 2, device=img.device)
    ym, xm = (ys - 1).clamp_min(0), (xs - 1).clamp_min(0)
    a = img[ym][:, xm]
    b = img[ym][:, xs]
    c = img[ys][:, xm]
    d = img[ys][:, xs]
    return 0.5 * (0.5 * (a + b) + 0.5 * (c + d))


def rigid_inverse(m):
    """The inverse of a rigid view matrix: [R^T | -R^T t]."""
    r, t = m[:3, :3], m[:3, 3]
    top = torch.cat([r.T, (-r.T @ t)[:, None]], 1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=F32,
                                        device=m.device)], 0)


def to_world(view_pos, cam_to_world):
    return view_pos @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]


def rotate(v, normal_mat):
    """Normals through the normal matrix, transpose(inverse(view))."""
    return v @ normal_mat[:3, :3].T


# ------------------------------------------------------------------- BRDF

def fresnel(cos_t, f0):
    c = (1.0 - cos_t).clamp(0.0, 1.0) ** 5
    return f0 + (1.0 - f0) * c[..., None]


def f0_of(albedo, metallic):
    return 0.04 + (albedo - 0.04) * metallic[..., None]


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    c2 = n_dot_h * n_dot_h
    den = (c2 * a2 + (1.0 - c2)) ** 2
    return torch.where(c2 > 0.0, a2, 0.0) / (BRDF_PI * den.clamp_min(1e-12))


def smith_g1(a2, n_dot_v):
    c2 = (n_dot_v * n_dot_v).clamp_min(1e-8)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - c2) / c2))


def smith_g2(n_dot_v, n_dot_l, a2):
    v2 = (n_dot_v * n_dot_v).clamp_min(1e-8)
    l2 = (n_dot_l * n_dot_l).clamp_min(1e-8)
    return 2.0 / (torch.sqrt(1.0 + a2 * (1.0 - v2) / v2)
                  + torch.sqrt(1.0 + a2 * (1.0 - l2) / l2))


def halton(i, base):
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton_table(count):
    """(count, 2) float32 (halton(i + 1, 2), halton(i + 1, 3))."""
    return np.asarray([[halton(i + 1, 2), halton(i + 1, 3)]
                       for i in range(count)], np.float32)


def ggx_vndf(ve, alpha, u1, u2):
    """Heitz's visible-normal sample, isotropic alpha."""
    vh = _norm(torch.stack([alpha * ve[..., 0], alpha * ve[..., 1],
                            ve[..., 2]], -1), 0.0)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(lensq.clamp_min(1e-20))
    t1 = torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                      torch.zeros_like(inv)], -1)
    t1 = torch.where((lensq > 0.0)[..., None], t1,
                     torch.tensor([1.0, 0.0, 0.0], dtype=F32,
                                  device=ve.device))
    t2 = torch.linalg.cross(vh, t1)
    u1 = torch.as_tensor(u1, dtype=F32, device=ve.device)
    u2 = torch.as_tensor(u2, dtype=F32, device=ve.device)
    r = torch.sqrt(u1)
    phi = 2.0 * BRDF_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(1.0 - p1 * p1) + s * p2
    p1 = p1.expand_as(p2)
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt((1.0 - p1 * p1 - p2 * p2).clamp_min(0.0))[..., None]
          * vh)
    return _norm(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                              nh[..., 2].clamp_min(0.0)], -1), 0.0)


def pdf_lut(size, device, steps=2000):
    """GGX direction-pdf table (preintegrate.comp). The integrand has a
    pole inside the table, where one rounding moves a term by orders of
    magnitude; the JAX package's compiled loop forms t, L and the
    denominator each as one fused multiply-add, so here each is formed
    exactly in float64 and rounded once to float32, as an FMA rounds."""
    px = (torch.arange(size, dtype=F32, device=device) + 0.5) / size
    a = (2.0 * px - 1.0)[None, :]
    b = px[:, None]
    p, q = (b - a).double(), (b + a).double()
    acc = torch.zeros(size, size, dtype=F32, device=device)
    step = float(np.float32(2.0 / steps))
    for i in range(steps):
        t = np.float32(step * (i + 0.5) - 1.0)
        big_l = (p * float(t) + q).float()
        tt1 = float(np.float32(float(t) * float(t) + 1.0))
        den = (-0.5 * big_l.double() * big_l.double() + tt1).float()
        nom = float(np.float32(1.0) - t) * big_l
        acc += torch.where(big_l > 0.0, nom / (den * den), 0.0)
    return 2.0 / steps * acc


def brdf_lut(size, device, samples=128):
    """Split-sum table (preintegrate_ssr.comp): x roughness, y NdotV."""
    px = (torch.arange(size, dtype=F32, device=device) + 0.5) / size
    rough = px[None, :].expand(size, size)
    ndv = px[:, None].expand(size, size)
    a2 = rough * rough
    v = torch.stack([torch.sqrt((1.0 - ndv * ndv).clamp_min(0.0)),
                     torch.zeros_like(ndv), ndv], -1)
    g1 = smith_g1(a2, ndv)
    sa = torch.zeros(size, size, dtype=F32, device=device)
    sb = torch.zeros_like(sa)
    table = halton_table(samples)
    for i in range(samples):
        hv = ggx_vndf(v, a2, table[i, 0], table[i, 1])
        vdh = _dot(v, hv)
        l = _norm(-v + 2.0 * vdh[..., None] * hv)
        fw = (1.0 - vdh) ** 5
        ratio = smith_g2(ndv, l[..., 2], a2) / g1.clamp_min(1e-20)
        sa += ratio * (1.0 - fw)
        sb += ratio * fw
    return torch.stack([sa / samples, sb / samples], -1)


def ggx_dir_pdf(table, w0, n, l, alpha):
    """sampleGGXdirPDF through the pdf table."""
    y = _norm(torch.linalg.cross(w0, n))
    x = _norm(torch.linalg.cross(y, w0))
    alpha = alpha.clamp(0.0, 0.9)
    lp = _norm(l - w0 * _dot(w0, l)[..., None])
    cos_t = _dot(x, lp)
    cos_p = _dot(n, x)
    sin_p = torch.sqrt((1.0 - cos_p * cos_p).clamp_min(0.0))
    a2 = alpha * alpha
    coef = torch.sqrt((1.0 - a2).clamp_min(1e-20))
    uv = torch.stack([0.5 * coef * cos_p * cos_t + 0.5, coef * sin_p], -1)
    return a2 / (2.0 * PI * coef) * sample_uv(table, uv)


# ----------------------------------------------------------------- passes

def hiz_half(depth, normal, velocity):
    """Half-res depth = min of each 2x2 quad; normal and velocity of the
    quad texel holding it, ties to (x+1, y), (x, y+1), (x+1, y+1), (x, y)
    in that order (downsample_gbuffer.frag)."""
    def quad(a):
        H, W = a.shape[:2]
        q = a.reshape(H // 2, 2, W // 2, 2, *a.shape[2:])
        return [q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], q[:, 1, :, 1]]

    d = quad(depth)
    m = torch.minimum(torch.minimum(d[0], d[1]), torch.minimum(d[2], d[3]))
    nq, vq = quad(normal), quad(velocity)
    n_out, v_out = nq[0], vq[0]
    for k in (3, 2, 1):
        hit = (d[k] == m)[..., None]
        n_out = torch.where(hit, nq[k], n_out)
        v_out = torch.where(hit, vq[k], v_out)
    return m, n_out, v_out


def ssr_filter(rays, depth_h, albedo, normal_h, material, normal_mat, lens):
    """filter.comp: five taps in a cross, each neighbour's ray weighted by
    this pixel's BRDF (F G2 / G1, G2 with its NdotL, NdotV slots swapped
    as the shader has them) and by depth."""
    h, w = depth_h.shape
    dev = depth_h.device
    mat = half_corner(material)[:h, :w]
    alb = half_corner(albedo[..., :3])[:h, :w]
    rough = mat[..., 1]
    f0 = f0_of(alb, mat[..., 2])
    ys = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    hit = rays[..., 3] != 1.0
    rad = torch.where(hit[..., None], sample_uv(albedo[..., :3],
                                                rays[..., :2]), 0.0)
    cs = torch.zeros(h, w, 3, dtype=F32, device=dev)
    ws = torch.zeros_like(cs)
    for dx, dy in ((0, 0), (-1, 0), (0, 1), (1, 0), (0, -1)):
        yi = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
        xi = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
        tr = rays[yi][:, xi]
        pd = depth_h[yi][:, xi]
        pn = rotate(decode_oct(normal_h[yi][:, xi]), normal_mat)
        p_uv = torch.stack([(xs / w) + dx / w, (ys / h) + dy / h], -1)
        vpos = lens.view_pos(p_uv, pd)
        hpos = lens.view_pos(tr[..., :2], tr[..., 2])
        v = _norm(-vpos)
        l = _norm(hpos - vpos)
        hv = _norm(v + l)
        f = fresnel(_dot(hv, v).clamp_min(0.0), f0)
        a2 = rough * rough
        ndl = _dot(pn, l).clamp_min(0.0)
        ndv = _dot(pn, v).clamp_min(0.0)
        wgt = f * (smith_g2(ndl, ndv, a2)
                   / smith_g1(a2, ndv).clamp_min(1e-20))[..., None]
        bw = (1.0 - 1000.0 * (depth_h - pd).abs()
              / depth_h.abs().clamp_min(1e-20)).clamp_min(0.0)
        wgt = wgt * bw[..., None]
        cs += wgt * rad[yi][:, xi]
        ws += wgt
    ws = torch.where(ws.amax(-1, keepdim=True) < 0.001, 1.0, ws)
    return cs / ws


def reprojected_world(prev_depth, velocity, cam_to_world, uv, lens):
    """World position of the previous frame's surface at uv + velocity,
    its depth fetched through the clamped reprojection gather."""
    h, w = velocity.shape[:2]
    d = gather_offset(prev_depth, velocity[..., 0] * w, velocity[..., 1] * h)
    return to_world(lens.view_pos(uv + velocity, d), cam_to_world)


def in_unit(uv):
    return ((uv[..., 0] >= 0) & (uv[..., 0] <= 1)
            & (uv[..., 1] >= 0) & (uv[..., 1] <= 1))


def ssr_blur(refl, depth_h, normal_h, material, history, velocity_h,
             prev_depth_h, c2w, prev_c2w, lens, max_roughness=1.0):
    """blur.comp: a gaussian of sigma 0.4-4 by roughness, weighted by
    depth and normal, then a 0.1 blend with the history where the
    reprojection holds."""
    h, w = depth_h.shape
    dev = depth_h.device
    rough = max_roughness * half_mean(material[..., 1])[:h, :w]
    sigma = 0.4 + 3.6 * rough
    r_pix = torch.floor(3.0 * sigma - 0.01)
    e = 2.0 * sigma * sigma
    n_c = decode_oct(normal_h)
    col = torch.zeros(h, w, 3, dtype=F32, device=dev)
    wsum = torch.zeros(h, w, dtype=F32, device=dev)
    ar_h, ar_w = torch.arange(h, device=dev), torch.arange(w, device=dev)
    for j in range(-BLUR_RADIUS, BLUR_RADIUS + 1):
        yi = (ar_h + j).clamp(0, h - 1)
        d_row, n_row, r_row = depth_h[yi], n_c[yi], refl[yi]
        for i in range(-BLUR_RADIUS, BLUR_RADIUS + 1):
            xi = (ar_w + i).clamp(0, w - 1)
            pd, pn = d_row[:, xi], n_row[:, xi]
            bw = (1.0 - 1000.0 * (depth_h - pd).abs()
                  / depth_h.abs().clamp_min(1e-20)).clamp_min(0.0)
            nw = _dot(n_c, pn).clamp_min(0.0)
            wgt = torch.exp(-float(i * i + j * j) / e) * bw * nw
            wgt = torch.where((abs(i) <= r_pix) & (abs(j) <= r_pix), wgt, 0.0)
            col += r_row[:, xi] * wgt[..., None]
            wsum += wgt
    col = col / torch.maximum(wsum, 0.001 * 2.0 * PI * sigma * sigma)[..., None]
    uv = pixel_centers(h, w, dev)
    w_cur = to_world(lens.view_pos(uv, depth_h), c2w)
    w_prev = reprojected_world(prev_depth_h, velocity_h, prev_c2w, uv, lens)
    err = torch.linalg.vector_norm(w_cur - w_prev, dim=-1)
    dist = torch.linalg.vector_norm(w_cur - c2w[:3, 3], dim=-1)
    vlen = torch.linalg.vector_norm(velocity_h, dim=-1)
    ok = in_unit(uv + velocity_h) & (
        (vlen < 1e-4) | (err < (0.1 * dist * vlen).clamp(0.01, 0.1)))
    return torch.where(ok[..., None], history + (col - history) * 0.1, col)


def base_angle(frame_index: int):
    """The frame's GTAO rotation: a table entry plus a hashed jitter."""
    hsh = (frame_index * 2654435761 + 1013904223) % (1 << 32)
    rnd = np.float32(hsh >> 8) / np.float32(1 << 24) - np.float32(0.5)
    return float(ANGLE_OFFSETS[frame_index % 12] + rnd)


def dither(h, w, device):
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None, :]
    return ((((x + y) & 3) << 2) + (x & 3)).to(F32) / 16.0


def gtao_mis(depth_h, normal_h, material, table, ssr_occ, normal_mat, lens,
             angle0, weight_ratio=1.0):
    """main.comp mis_gtao: one horizon slice at the pixel's dithered angle,
    16 bilinear depth taps along it, MIS-combined with the SSR march's
    GGX occlusion estimate (sum, pdf)."""
    h, w = depth_h.shape
    dev = depth_h.device
    uv = pixel_centers(h, w, dev)
    pos = lens.view_pos(uv, depth_h)
    w0 = _norm(-pos)
    cam_n = _norm(rotate(decode_oct(normal_h), normal_mat))
    radius = (100.0 / torch.linalg.vector_norm(pos, dim=-1)
              .clamp_min(1e-20)).clamp_max(16.0)
    ang = 2.0 * PI * (dither(h, w, dev) + angle0)
    dir_uv = radius[..., None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], -1) / torch.tensor(
            [w, h], dtype=F32, device=dev)
    end = lens.view_pos(uv + dir_uv, depth_h)
    ldir = _norm(end - pos)
    slice_n = _norm(torch.linalg.cross(w0, -end))
    n_proj = cam_n - _dot(cam_n, slice_n)[..., None] * slice_n
    n_len = torch.linalg.vector_norm(n_proj, dim=-1).clamp_min(1e-20)
    x_axis = _norm(-torch.linalg.cross(slice_n, w0))
    n_ang = PI / 2.0 - torch.arccos(
        _dot(n_proj / n_len[..., None], x_axis).clamp(-1.0, 1.0))
    h_cos = torch.full((h, w), -1.0, dtype=F32, device=dev)
    prev_z = pos[..., 2]
    alive = torch.ones(h, w, dtype=torch.bool, device=dev)
    for i in range(1, GTAO_STEPS + 1):
        f = i / GTAO_STEPS
        sd = gather_offset(depth_h, f * (dir_uv[..., 0] * w),
                           f * (dir_uv[..., 1] * h), radius=GTAO_STEPS)
        sp = lens.view_pos(uv + f * dir_uv, sd)
        alive = alive & ~(sp[..., 2] > prev_z + GTAO_THICKNESS)
        prev_z = torch.where(alive, sp[..., 2], prev_z)
        off = sp - pos
        s_cos = _dot(w0, off) / torch.linalg.vector_norm(off, dim=-1) \
            .clamp_min(1e-20)
        h_cos = torch.where(alive, torch.maximum(h_cos, s_cos), h_cos)
    hz = torch.arccos(h_cos.clamp(-1.0, 1.0))
    hz = torch.minimum(n_ang + (hz - n_ang).clamp_max(PI / 2.0), hz)
    arc = n_len * 0.25 * (-torch.cos(2.0 * hz - n_ang) + torch.cos(n_ang)
                          + 2.0 * hz * torch.sin(n_ang)).clamp_min(0.0)
    occ = arc / PI
    rough = half_mean(material[..., 1])[:h, :w]
    pdf_ggx = ggx_dir_pdf(table, w0, cam_n, ldir, rough * rough)
    pdf_u = 1.0 / (2.0 * PI)
    alpha = 1.0 / (weight_ratio + 1.0)
    beta = 1.0 - alpha
    mis = (ssr_occ[..., 0] * (alpha / (alpha * ssr_occ[..., 1] + beta * pdf_u))
           + occ * (beta / (alpha * pdf_ggx + beta * pdf_u)))
    mis = torch.where(torch.isnan(mis), occ / pdf_u, mis)
    return torch.where(depth_h >= 1.0, 0.0, mis)


def gtao_filter(depth_h, raw, lens):
    """filter.comp: 4x4 taps at offsets -2..+1, weight
    max(0, 1 - 5 |z_s - z| / |z|) in linear depth."""
    h, w = depth_h.shape
    dev = depth_h.device
    z = lens.linear_z(depth_h)
    acc = torch.zeros(h, w, dtype=F32, device=dev)
    wsum = torch.zeros_like(acc)
    for dx in range(-2, 2):
        for dy in range(-2, 2):
            yi = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
            xi = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
            zs = lens.linear_z(depth_h[yi][:, xi])
            wgt = (1.0 - 5.0 * (zs - z).abs() / z.abs()).clamp_min(0.0)
            wsum += wgt
            acc += wgt * raw[yi][:, xi]
    return acc / wsum.clamp_min(1e-20)


def gtao_accumulate(depth_h, prev_depth_h, ao, velocity_h, history, c2w,
                    prev_c2w, mvp, lens, first_frame: bool):
    """accum.comp: running mean over reprojected history, the count in .y
    (/255), checked by the previous surface's reprojected uv and depth."""
    h, w = depth_h.shape
    dev = depth_h.device
    uv = pixel_centers(h, w, dev)
    w_prev = reprojected_world(prev_depth_h, velocity_h, prev_c2w, uv, lens)
    hom = torch.cat([w_prev, torch.ones_like(w_prev[..., :1])], -1) @ mvp.T
    wc = hom[..., 3:4]
    ndc = hom[..., :3] / torch.where(wc.abs() < 1e-20, 1e-20, wc)
    delta = (0.5 * ndc[..., :2] + 0.5 - uv).abs() * torch.tensor(
        [w, h], dtype=F32, device=dev)
    depth_err = (lens.linear_z(ndc[..., 2]) - lens.linear_z(depth_h)).abs()
    vel = torch.maximum(velocity_h[..., 0].abs() * w,
                        velocity_h[..., 1].abs() * h)
    valid = (1.0 - (0.1 * vel + depth_err)).clamp(0.8, 1.0)
    ok = (in_unit(uv + velocity_h) & (delta.amax(-1) <= 2.0)
          & (depth_err < 0.2))
    if first_frame:
        ok = torch.zeros_like(ok)
    acc = gather_offset(history, velocity_h[..., 0] * w,
                        velocity_h[..., 1] * h)
    n = 255.0 * acc[..., 1] * valid
    mean = (acc[..., 0] * n + ao) / (n + 1.0)
    n1 = torch.where(n + 1.0 > 255.0, 100.0, n + 1.0)
    out_ao = torch.where(ok, mean, ao)
    out_n = torch.where(ok, n1, 1.0)
    return torch.stack([out_ao.clamp(0.0, 1.0), out_n / 255.0], -1)


def upsample2(img, ox, oy):
    """texture(half_img, full_uv + texel offset (ox, oy)) with the linear
    sampler at every full-res pixel: full pixel x lies at half texel
    x/2 - 0.25 + ox, so even pixels blend texels (i - 1, i) by (0.25,
    0.75) and odd ones (i, i + 1) by (0.75, 0.25), rows first, then
    columns, clamped at the edge (the JAX package's dense form)."""
    def along(a, axis, off):
        n = a.shape[axis]
        i = torch.arange(n, device=a.device)

        def at(k):
            return a.index_select(axis, (i + k).clamp(0, n - 1))
        lo, mid, hi = at(off - 1), at(off), at(off + 1)
        even, odd = 0.25 * lo + 0.75 * mid, 0.75 * mid + 0.25 * hi
        out = torch.stack([even, odd], axis + 1)
        return out.reshape(*a.shape[:axis], 2 * n, *a.shape[axis + 1:])

    return along(along(img, 0, oy), 1, ox)


def upsample_pick(depth, depth_h, occ_h, refl_h):
    """shader.frag sample_ocllusion_ssr: of the four half-res texels
    around each pixel (texel offsets (0,0), (1,0), (0,1), (1,1) on the
    linear sampler), take the AO and reflection of the one whose depth
    is nearest the pixel's, the first of them on a tie."""
    best_d = best_o = best_r = None
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        gap = (upsample2(depth_h, ox, oy) - depth).abs()
        o = upsample2(occ_h, ox, oy)
        r = upsample2(refl_h, ox, oy)
        if best_d is None:
            best_d, best_o, best_r = gap, o, r
        else:
            take = gap < best_d
            best_d = torch.where(take, gap, best_d)
            best_o = torch.where(take, o, best_o)
            best_r = torch.where(take[..., None], r, best_r)
    return best_o, best_r


def shade(albedo, normal, material, depth, occ, refl, table, c2w, lens,
          min_rough=0.0, max_rough=1.0):
    """defered_shading shader.frag: one point light (GGX with
    height-correlated Smith G2, Lambert), 0.6 ambient, SSR through the
    split-sum table, all under the AO."""
    H, W = depth.shape
    uv = pixel_centers(H, W, depth.device)
    n = decode_oct(normal)
    alb = albedo[..., :3]
    metal = 0.1 + 0.9 * material[..., 2]
    rough = material[..., 1]
    wpos = to_world(lens.view_pos(uv, depth), c2w)
    v = _norm(c2w[:3, 3] - wpos)
    f0 = f0_of(alb, metal)
    to_l = torch.tensor(LIGHT_POS, dtype=F32, device=depth.device) - wpos
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    l = to_l / dist[..., None].clamp_min(1e-20)
    hv = _norm(v + l)
    radiance = torch.tensor(LIGHT_RADIANCE, dtype=F32, device=depth.device) \
        * (100.0 / (dist * dist)).clamp_max(100.0)[..., None]
    ndl = _dot(n, l).clamp_min(0.0)
    ndv = _dot(n, v).clamp_min(0.0)
    ndh = _dot(n, hv)
    hdv = _dot(hv, v).clamp_min(0.0)
    f = fresnel(hdv, f0)
    spec = (ggx_d(ndh, rough) * smith_g2(ndv, ndl, rough * rough))[..., None] \
        * f / (4.0 * ndv * ndl + 1e-4)[..., None]
    kd = (1.0 - f) * (1.0 - metal)[..., None]
    lo = (kd * alb / BRDF_PI + spec) * radiance * ndl[..., None]
    br = min_rough + (max_rough - min_rough) * rough
    ab = sample_uv(table, torch.stack([br, ndv], -1))
    lo = lo + refl * (f0 * ab[..., 0:1] + ab[..., 1:2])
    return occ[..., None] * (0.6 * alb + lo)


def taa(history, prev_depth, depth, velocity, colour, c2w, prev_c2w, lens):
    """resolve.comp: the reprojected history clamped to its four
    neighbours' box, blended 0.1 toward the frame where the
    world-position check holds."""
    H, W = depth.shape
    uv = pixel_centers(H, W, depth.device)
    ox, oy = velocity[..., 0] * W, velocity[..., 1] * H
    hist = gather_offset(history, ox, oy)
    taps = [gather_offset(history, ox + tx, oy + ty)
            for tx, ty in ((1, 0), (0, 1), (-1, 0), (0, -1))]
    lo = torch.minimum(torch.minimum(taps[0], taps[1]),
                       torch.minimum(taps[2], taps[3]))
    hi = torch.maximum(torch.maximum(taps[0], taps[1]),
                       torch.maximum(taps[2], taps[3]))
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    blended = hist + (colour - hist) * 0.1
    w_cur = to_world(lens.view_pos(uv, depth), c2w)
    w_prev = reprojected_world(prev_depth, velocity, prev_c2w, uv, lens)
    err = torch.linalg.vector_norm(w_cur - w_prev, dim=-1)
    dist = torch.linalg.vector_norm(w_cur - c2w[:3, 3], dim=-1)
    dlen = torch.linalg.vector_norm(velocity, dim=-1)
    ok = in_unit(uv + velocity) & (
        (dlen < 0.005) | (err < (0.1 * dist * dlen).clamp(0.01, 0.2)))
    return torch.where(ok[..., None], blended, colour)


# ------------------------------------------------------- ray-traced AO

class Grid:
    """A uniform grid over the world-space triangles (scene_as.cpp's
    acceleration structure as the JAX package's scene/accel.py states
    it): `resolution` cells on the longest axis, each listing the first
    `cap` triangles, by id, whose bounding box overlaps it."""

    def __init__(self, world_tris, resolution, cap, device):
        tri = np.asarray(world_tris, np.float64)            # (T, 3, 3)
        t_lo, t_hi = tri.min(1), tri.max(1)
        lo, hi = t_lo.min(0), t_hi.max(0)
        extent = np.maximum(hi - lo, 1e-9)
        dims = np.maximum(1, np.round(extent / extent.max() * resolution)
                          .astype(np.int64))
        cell = extent / dims
        c_lo = np.clip(((t_lo - lo) / cell).astype(np.int64), 0, dims - 1)
        c_hi = np.clip(((t_hi - lo) / cell).astype(np.int64), 0, dims - 1)
        span = c_hi - c_lo + 1
        # every (triangle, cell) pair, triangles in id order
        n = span.prod(1)
        tid = np.repeat(np.arange(len(tri)), n)
        k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        sx, sy = span[tid, 0], span[tid, 1]
        cx = c_lo[tid, 0] + k % sx
        cy = c_lo[tid, 1] + (k // sx) % sy
        cz = c_lo[tid, 2] + k // (sx * sy)
        flat = (cz * dims[1] + cy) * dims[0] + cx
        order = np.argsort(flat, kind="stable")
        flat, tid = flat[order], tid[order]
        first = np.searchsorted(flat, flat, side="left")
        slot = np.arange(len(flat)) - first
        keep = slot < cap
        table = np.full((int(dims.prod()), cap), -1, np.int64)
        table[flat[keep], slot[keep]] = tid[keep]
        self.tris = torch.as_tensor(tri, dtype=F32, device=device)
        self.cells = torch.as_tensor(table, device=device)
        self.lo = torch.as_tensor(lo, dtype=F32, device=device)
        self.cell = torch.as_tensor(cell, dtype=F32, device=device)
        self.dims = [int(d) for d in dims]
        self.cap = cap


def _hits(o, d, v0, e1, e2, t_max):
    """Moller-Trumbore any-hit for t in (1e-12, t_max)."""
    p = torch.linalg.cross(d, e2)
    det = _dot(e1, p)
    small = det.abs() < 1e-20
    inv = torch.where(small, 0.0, 1.0 / torch.where(det == 0.0, 1.0, det))
    s = o - v0
    u = _dot(s, p) * inv
    q = torch.linalg.cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    return (~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-12) & (t < t_max))


def any_hit(grid: Grid, o, d, t_max, max_steps):
    """rayQuery's any-hit over the grid: a 3-D DDA through the cells the
    segment o + t d, t in (0, t_max], pierces, at most max_steps cells,
    each cell's triangles tested. o, d: (N, 3)."""
    dims = torch.tensor(grid.dims, device=o.device)
    sx, sy, _ = grid.dims
    small = d.abs() < 1e-20
    inv = torch.where(small, 1e20, 1.0 / torch.where(d == 0.0, 1.0, d))
    ic = torch.floor((o - grid.lo) / grid.cell).long()
    ic = torch.minimum(torch.maximum(ic, torch.zeros_like(ic)), dims - 1)
    step = torch.where(d >= 0.0, 1, -1)
    t_next = ((ic + (step > 0).long()).to(F32) * grid.cell + grid.lo - o) * inv
    t_next = torch.where(small, 1e20, t_next)
    dt = (grid.cell * inv).abs()
    hit = torch.zeros(len(o), dtype=torch.bool, device=o.device)
    alive = torch.ones_like(hit)
    for _ in range(max_steps):
        todo = (alive & ~hit).nonzero().squeeze(1)
        if len(todo):
            c = ic[todo]
            flat = ((c[:, 2] * sy + c[:, 1]) * sx + c[:, 0])
            slots = grid.cells[flat]                           # (n, cap)
            tv = grid.tris[slots.clamp_min(0)]                  # (n, cap, 3, 3)
            v0 = tv[:, :, 0]
            m = _hits(o[todo, None], d[todo, None], v0, tv[:, :, 1] - v0,
                      tv[:, :, 2] - v0, t_max) & (slots >= 0)
            hit[todo] |= m.any(1)
        tmin, ax = t_next.min(-1)
        onehot = ax[:, None] == torch.arange(3, device=o.device)
        ic_new = ic + torch.where(onehot, step, 0)
        t_next = t_next + torch.where(onehot, dt, 0.0)
        inside = ((ic_new >= 0) & (ic_new < dims)).all(-1)
        alive = alive & inside & (tmin <= t_max)
        ic = torch.where(alive[:, None], ic_new, ic)
    return hit


def ao_directions(count=64, seed=7):
    """gtao.cpp's fixed hemisphere set: uniform unit vectors with z >= 0
    by rejection, from a seeded generator (the JAX package's stand-in
    for std::default_random_engine)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        v = rng.uniform(-1.0, 1.0, 3)
        v[2] = abs(v[2])
        n = float(np.linalg.norm(v))
        if 1e-5 < n <= 1.0:
            out.append(v / n)
    return np.asarray(out, np.float32)


def gtao_rt(depth_h, normal_h, grid, c2w, lens, rotation, directions,
            rt_radius, max_steps=12, dir_chunk=8, ray_chunk=1 << 21):
    """rt_main.frag: the direction set turned into each pixel's surface
    frame by its dither angle and the frame's rotation, each ray cast
    rt_radius from the surface; AO = 2 mean(unoccluded NdotL), summed
    dir_chunk directions at a time."""
    h, w = depth_h.shape
    dev = depth_h.device
    uv = pixel_centers(h, w, dev)
    n = decode_oct(normal_h)
    pos = to_world(lens.view_pos(uv, depth_h), c2w) + 1e-6 * n
    t = tangent_of(n)
    b = _norm(torch.linalg.cross(n, t))
    t = torch.linalg.cross(b, n)
    ang = 2.0 * PI * (rotation + dither(h, w, dev))
    t = _norm(torch.cos(ang)[..., None] * t + torch.sin(ang)[..., None] * b)
    b = _norm(torch.linalg.cross(n, t))
    t = _norm(torch.linalg.cross(b, n))
    dirs = torch.as_tensor(directions, dtype=F32, device=dev)
    n_f, t_f, b_f, p_f = (a.reshape(1, -1, 3) for a in (n, t, b, pos))
    total = torch.zeros(h * w, dtype=F32, device=dev)
    for c0 in range(0, len(dirs), dir_chunk):
        dl = _norm(dirs[c0:c0 + dir_chunk])[:, None, :]        # (C, 1, 3)
        dw = _norm(dl[..., 2:3] * n_f + dl[..., 0:1] * t_f
                   + dl[..., 1:2] * b_f)                        # (C, hw, 3)
        ndl = _dot(dw, n_f).clamp_min(0.0)
        o = p_f.expand_as(dw).reshape(-1, 3)
        d = dw.reshape(-1, 3)
        hit = torch.cat([any_hit(grid, o[s0:s0 + ray_chunk],
                                 d[s0:s0 + ray_chunk], float(rt_radius),
                                 max_steps)
                         for s0 in range(0, len(o), ray_chunk)])
        total = total + (torch.where(hit.reshape(ndl.shape), 0.0, 1.0)
                         * ndl).sum(0)
    ao = (2.0 * total / len(dirs)).reshape(h, w)
    return torch.where(depth_h >= 1.0, 0.0, ao)


def tangent_of(n):
    """main.comp get_tangent: (n.y, -n.x, 0), or x where n is along z."""
    flat_xy = torch.maximum(n[..., 0].abs(), n[..., 1].abs()) < 1e-5
    t = torch.stack([n[..., 1], -n[..., 0], torch.zeros_like(n[..., 0])], -1)
    t = torch.where(flat_xy[..., None], torch.tensor(
        [1.0, 0.0, 0.0], dtype=F32, device=n.device), t)
    return _norm(t)


# ---------------------------------------------------------------- probe GI
# vkr_tpu/passes/probes.py and frame.compose_probe_reflections: the cube
# faces resampled to octahedral maps, the min pyramid of their planar
# depth, and the reflected ray marched through up to 4 neighbouring
# probes in up to 4 octant segments each, neighbours and segments walked
# in the JAX package's loop order. Where a Python number is divided by a
# tensor, one division, as XLA computes it (PyTorch would multiply by the
# reciprocal).

PROBE_ZNEAR, PROBE_ZFAR = 0.05, 80.0
PROBE_STEPS = 25
MAX_T = 3.402823466e38


def _over(num: float, t):
    """num / t, one division."""
    return torch.full_like(t, num) / t


def _to_int(x):
    """float -> int32 toward zero, saturating as XLA's cast does."""
    return x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


def encode_oct(n):
    """Unit vector -> octahedral uv in [0, 1]^2 (octahedral.glsl
    oct_encode)."""
    l1 = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    xy = n[..., :2] / l1[..., None]
    folded = (1.0 - xy.flip(-1).abs()) * torch.where(xy >= 0.0, 1.0, -1.0)
    xy = torch.where((n[..., 2] < 0.0)[..., None], folded, xy)
    return 0.5 * xy + 0.5


def encode_oct_depth(z):
    """Planar depth along the octant diagonal (octahedral.glsl:70-72)."""
    f, n = PROBE_ZFAR, PROBE_ZNEAR
    return f / (f - n) + _over(f * n, (-z) * (f - n))


def oct_center(uv):
    """The octant diagonal through uv, sign(0) = 0 as in GLSL."""
    u = 2.0 * (uv - 0.5)
    v = torch.cat([u, (1.0 - u[..., 0].abs() - u[..., 1].abs())[..., None]],
                  -1)
    s = torch.where(v >= 0.0, 1.0, -1.0)
    s = torch.where(v == 0.0, 0.0, s)
    return s / torch.linalg.vector_norm(s, dim=-1, keepdim=True).clamp_min(
        1e-20)


def sample_cube(faces, d):
    """samplerCube: the face of the dominant axis, bilinear within it.
    faces (6, S, S, C) in +x, -x, +y, -y, +z, -z order; d (..., 3)."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp_min(1e-20)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y,
                     torch.where(is_y, torch.where(y > 0, z, -z), -y))
    uv = torch.stack([(sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5], -1)
    out = sample_uv(faces[0], uv)
    for f in range(1, 6):
        out = torch.where((face == f)[..., None], sample_uv(faces[f], uv),
                          out)
    return out


def cube_to_oct(colour_faces, dist_faces, size):
    """cube2oct/shader.comp: the octahedral colour and planar depth at
    uv = texel / size (no half-texel offset)."""
    xs = torch.arange(size, dtype=F32, device=colour_faces.device) / size
    uv = torch.stack([xs.expand(size, size), xs[:, None].expand(size, size)],
                     -1)
    d = decode_oct(uv)
    colour = sample_cube(colour_faces, d)
    dist = sample_cube(dist_faces[..., None], d)[..., 0]
    planar = (d * dist[..., None] * oct_center(uv)).sum(-1)
    return colour, encode_oct_depth(planar.clamp(PROBE_ZNEAR, PROBE_ZFAR))


def min_pyramid(depth):
    """probe_downsample: the min of each 2x2, down to one texel."""
    mips = [depth]
    while min(mips[-1].shape) > 1:
        h, w = mips[-1].shape
        mips.append(mips[-1][: h // 2 * 2, : w // 2 * 2].reshape(
            h // 2, 2, w // 2, 2).amin(dim=(1, 3)))
    return mips


class Probes:
    """The probe grid worked out from its cube faces: per probe the
    octahedral colour, and its depth pyramid packed mip after mip."""

    def __init__(self, faces, probe_min, probe_max, grid_size, oct_size,
                 device):
        colours, flats = [], []
        for colour_faces, dist_faces in faces:
            colour, depth = cube_to_oct(colour_faces.to(device),
                                        dist_faces.to(device), oct_size)
            mips = min_pyramid(depth)
            colours.append(colour)
            flats.append(torch.cat([m.reshape(-1) for m in mips]))
        self.sizes = [int(m.shape[0]) for m in mips]
        self.offsets = torch.as_tensor(
            np.cumsum([0] + [s * s for s in self.sizes])[:-1], device=device)
        self.size_t = torch.as_tensor(self.sizes, device=device)
        self.colours = torch.stack(colours)
        self.flat = torch.stack(flats)
        self.pmin = torch.as_tensor(probe_min, dtype=F32, device=device)
        self.pmax = torch.as_tensor(probe_max, dtype=F32, device=device)
        self.n = grid_size
        # 2^-m for m = -1 .. PROBE_STEPS + 1, exact
        self.scale = torch.tensor([2.0 ** -m for m in range(
            -1, PROBE_STEPS + 2)], dtype=F32, device=device)

    def depth(self, probe, mip, x, y):
        """Texel (x, y) of mip `mip` of each lane's probe, clamped."""
        s = self.size_t[mip.long()]
        xi = torch.minimum(x.clamp_min(0), s - 1)
        yi = torch.minimum(y.clamp_min(0), s - 1)
        idx = (probe.clamp(0, len(self.flat) - 1).long() * self.flat.shape[1]
               + self.offsets[mip.long()] + yi * s + xi)
        return self.flat.reshape(-1)[idx]

    def colour(self, probe, uv):
        """Bilinear colour of each lane's probe at octahedral uv."""
        p, s = self.colours.shape[:2]
        flat = self.colours.reshape(p * s * s, 3)
        x, y = uv[..., 0] * s - 0.5, uv[..., 1] * s - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
        x0, y0 = _to_int(x0), _to_int(y0)
        base = probe.clamp(0, p - 1).long() * (s * s)

        def tap(xi, yi):
            return flat[base + yi.clamp(0, s - 1) * s + xi.clamp(0, s - 1)]

        top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
        bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
        return top * (1 - fy) + bot * fy


def _inv(d):
    return torch.where(d != 0.0, 1.0 / torch.where(d == 0.0, 1.0, d), MAX_T)


def probe_march(probes: Probes, probe, origin, direction, steps):
    """hierarchical_raymarch through one probe's octahedral depth
    pyramid, t clamped to 1 (trace_probe/shader.comp:218-268). Returns
    the stop point and whether the walk left mip 0 within `steps`."""
    base = float(probes.sizes[0])
    n_mips = len(probes.sizes)
    inv = _inv(direction)
    neg = direction[..., :2] < 0
    uv_offset = torch.where(neg, -0.005 / base, 0.005 / base)
    floor_offset = torch.where(neg, 0.0, 1.0)
    plane = (torch.floor(base * origin[..., :2]) + floor_offset) / base
    t0 = (plane + uv_offset - origin[..., :2]) * inv[..., :2]
    t = torch.minimum(t0[..., 0], t0[..., 1])
    pos = origin + t[..., None] * direction
    mip = torch.zeros(origin.shape[:-1], dtype=torch.int32,
                      device=origin.device)
    done = torch.zeros_like(mip, dtype=torch.bool)
    iters = torch.zeros_like(mip)
    for i in range(steps):
        res = base * probes.scale[(mip + 1).clamp(0, len(probes.scale) - 1)
                                  .long()]
        at = res[..., None] * pos[..., :2]
        surface = probes.depth(probe, mip.clamp(0, n_mips - 1),
                               _to_int(at[..., 0]), _to_int(at[..., 1]))
        plane = (torch.floor(at) + floor_offset) / res[..., None] + uv_offset
        t_xy = (plane - origin[..., :2]) * inv[..., :2]
        t_z = torch.where(direction[..., 2] > 0,
                          (surface - origin[..., 2]) * inv[..., 2], MAX_T)
        t_min = torch.minimum(torch.minimum(torch.minimum(
            t_xy[..., 0], t_xy[..., 1]), t_z), torch.ones_like(t_z))
        above = surface > pos[..., 2]
        skipped = (t_min != t_z) & above
        new_t = torch.where(above, t_min, t).clamp(-1e20, 1e20)
        new_mip = mip + torch.where(skipped, 1, -1).to(torch.int32)
        live = ~done
        pos = torch.where(live[..., None], origin + new_t[..., None]
                          * direction, pos)
        t = torch.where(live, new_t, t)
        mip = torch.where(live, new_mip, mip)
        done = done | (new_mip < 0)
        iters = torch.where(live, i + 1, iters)
    iters = torch.where(done, iters, steps + 1)
    pos = torch.where(torch.isfinite(pos), pos, 0.0).clamp(-1e6, 1e6)
    return pos, iters <= steps


def trace_segment(probes: Probes, probe, origin, r, t0, t1,
                  steps=PROBE_STEPS):
    """trace_segment_hi (trace_probe/shader.comp:270-323): 0 miss, 1 hit,
    2 cannot tell; and the octahedral uv where the march stopped."""
    eps = 0.001
    p0 = origin + r * (t0 + eps)[..., None]
    p1 = origin + r * (t1 - eps)[..., None]
    p0 = torch.where((((p1 - p0) ** 2).sum(-1) < 0.001)[..., None], r, p0)
    o0 = encode_oct(_norm(p0))
    o1 = encode_oct(_norm(p1))
    front = oct_center(0.5 * (o0 + o1))
    d0 = encode_oct_depth((p0 * front).sum(-1).clamp_min(1e-6)) - 0.0005
    d1 = encode_oct_depth((p1 * front).sum(-1).clamp_min(1e-6))
    start = torch.cat([o0, d0[..., None]], -1)
    stop, valid = probe_march(probes, probe, start,
                              torch.cat([o1, d1[..., None]], -1) - start,
                              steps)
    size = probes.sizes[0]
    sampled = probes.depth(probe, torch.zeros_like(probe),
                           _to_int(stop[..., 0] * size),
                           _to_int(stop[..., 1] * size))
    z = stop[..., 2]
    code = torch.where(z > sampled + 0.0005, 2,
                       torch.where(z > sampled - 0.0005, 1, 0))
    code = torch.where(~valid | (z > 1.0), 0, code)
    return code, stop[..., :2]


def probe_trace(depth_h, normal_h, probes: Probes, c2w, lens,
                steps=PROBE_STEPS):
    """ProbeTracePass (trace_probe/shader.comp): each half-res pixel's
    reflected ray against the 4 probes around it; a probe's first segment
    that hits (1) or cannot tell (2) settles the pixel, and only a hit
    gives it the probe's colour. Returns (h, w, 4): colour and 1 where a
    probe hit, else 0."""
    h, w = depth_h.shape
    n = decode_oct(normal_h)
    eye = c2w[:3, 3]
    pos = to_world(lens.view_pos(pixel_centers(h, w, depth_h.device),
                                 depth_h), c2w) + 1e-6 * n
    v = _norm(pos - eye)
    pos = pos - 1e-6 * v
    r = v - 2.0 * _dot(v, n)[..., None] * n
    gs = probes.n
    step = (probes.pmax - probes.pmin) / torch.full_like(
        probes.pmin, max(gs - 1, 1))
    coord = ((pos - probes.pmin) / torch.where(step.abs() < 1e-9, 1.0, step)
             ).clamp(0.0, gs - 2 if gs > 1 else 0)
    sx = _to_int(torch.floor(coord[..., 0]))
    sy = _to_int(torch.floor(coord[..., 2]))
    out = torch.zeros((h, w, 4), dtype=F32, device=depth_h.device)
    settled = torch.zeros((h, w), dtype=torch.bool, device=depth_h.device)
    inv_r = _inv(r)
    for i in range(4 if gs > 1 else 1):
        gx, gy = sx + (i & 1), sy + ((i >> 1) & 1)
        probe = (gy * gs + gx).clamp(0, gs * gs - 1)
        centre = probes.pmin + torch.stack(
            [gx.to(F32), torch.zeros_like(gx, dtype=F32), gy.to(F32)],
            -1) * step
        origin = pos - centre
        cuts = torch.sort(-origin * inv_r, dim=-1).values.clamp(1e-6, 30.0)
        bounds = [torch.full_like(cuts[..., 0], 1e-6), cuts[..., 0],
                  cuts[..., 1], cuts[..., 2],
                  torch.full_like(cuts[..., 0], 30.0)]
        for s in range(4):
            ok = (bounds[s + 1] - bounds[s]).abs() >= 0.002
            code, uv = trace_segment(probes, probe, origin, r, bounds[s],
                                     bounds[s + 1], steps)
            hit = (code == 1) & ok & ~settled
            out = torch.where(hit[..., None], torch.cat(
                [probes.colour(probe, uv), torch.ones_like(uv[..., :1])],
                -1), out)
            settled = settled | hit | ((code == 2) & ok)
    return torch.where((depth_h >= 1.0)[..., None], 0.0, out)


def compose_probes(ssr, rays, probe):
    """The probes' reflections in the pixels the SSR trace found empty
    (rays w = 1)."""
    return torch.where(rays[..., 3:4] >= 1.0, probe[..., :3] * probe[..., 3:4],
                       ssr)


# ------------------------------------------------------------ the chain

class Tables:
    """The two preintegrated tables, worked out here."""

    def __init__(self, lut_size, device):
        self.pdf = pdf_lut(lut_size, device)
        self.brdf = brdf_lut(lut_size, device)


def chain(frame: dict, state_in: dict, view, prev_view, mvp, march: dict,
          cfg, tables: Tables, grid: "Grid | None", frozen: dict,
          frozen_state: dict, probes: "Probes | None" = None) -> dict:
    """The image-space chain of one frame, stage by stage (see the module
    docstring). frame: the judged frame's tensors by check.outputs'
    names; state_in: the FrameState fields carried into it; march: the
    frozen frame's SSR march outputs, "rays" and "ssr_occ"; grid: the
    scene's, for ray-traced GTAO (MIS GTAO without); frozen,
    frozen_state: the frozen frame's tensors and the state carried into
    it, which shading and TAA start from; probes: the probe grid, for
    probe GI. With probes the SSR image is composed with the frame's own
    probe image (ind_ssr), and the chain's probe image and the SSR image
    composed with it form ind_probe: a rounding can flip a probe hit, and
    SSR's number should not read it.
    Returns the tensors to compare with the frame's, by group and
    name."""
    g = {k: frame[f"gbuffer.{k}"] for k in
         ("albedo", "normal", "material", "velocity", "depth")}
    lens = Lens(cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                cfg.camera.zfar)
    c2w, prev_c2w = rigid_inverse(view), rigid_inverse(prev_view)
    normal_mat = c2w.T
    index = int(state_in["frame_index"])

    depth_h, normal_h, vel_h = hiz_half(g["depth"], g["normal"], g["velocity"])
    refl = ssr_filter(march["rays"], depth_h, g["albedo"], normal_h, g["material"],
                      normal_mat, lens)
    ssr = ssr_blur(refl, depth_h, normal_h, g["material"],
                   state_in["ssr_history"], vel_h, state_in["prev_depth_half"],
                   c2w, prev_c2w, lens, cfg.ssr.max_roughness)
    ind_probe = None
    if probes is not None:
        probe = probe_trace(depth_h, normal_h, probes, c2w, lens)
        ind_probe = {"probe": probe,
                     "ssr": compose_probes(ssr, march["rays"], probe)}
        ssr = compose_probes(ssr, march["rays"], frame["probe"])
    if grid is None:
        raw = gtao_mis(depth_h, normal_h, g["material"], tables.pdf,
                       march["ssr_occ"], normal_mat, lens, base_angle(index),
                       cfg.gtao.weight_ratio)
    else:
        raw = gtao_rt(depth_h, normal_h, grid, c2w, lens, base_angle(index),
                      ao_directions(cfg.gtao.rt_directions),
                      cfg.gtao.rt_radius)
    accum = gtao_accumulate(depth_h, state_in["prev_depth_half"],
                            gtao_filter(depth_h, raw, lens), vel_h,
                            state_in["gtao_accum"], c2w, prev_c2w, mvp, lens,
                            index == 0)
    f = {k: frozen[f"gbuffer.{k}"] for k in g}
    occ, refl_full = upsample_pick(f["depth"], hiz_half(
        f["depth"], f["normal"], f["velocity"])[0], frozen["ao"],
        frozen["ssr"])
    colour = shade(f["albedo"], f["normal"], f["material"], f["depth"], occ,
                   refl_full, tables.brdf, c2w, lens,
                   cfg.shading.min_roughness, cfg.shading.max_roughness)
    final = taa(frozen_state["taa_history"], frozen_state["prev_depth"],
                f["depth"], f["velocity"], colour, c2w, prev_c2w, lens)
    out = {"ind_ssr": {"ssr": ssr, "state.ssr_history": ssr,
                       "state.prev_depth_half": depth_h},
           "ind_ao": {"ao": accum[..., 0], "state.gtao_prev": accum[..., 0],
                      "state.gtao_accum": accum},
           "ind_colour": {"colour": final, "state.taa_history": final}}
    if ind_probe is not None:
        out["ind_probe"] = ind_probe
    return out
