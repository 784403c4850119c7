"""PBR BRDF math.

Same formulas as the reference's shaders/include/brdf.glsl: GGX NDF
(brdf.glsl:31-38 alpha-parameterized variant), height-correlated Smith G2
(brdf.glsl:48-56), Schlick fresnel (brdf.glsl:6-8), F0 approximation
(brdf.glsl:10-13), and the Heitz GGX VNDF sampler (brdf.glsl:147-167).
All functions broadcast over leading axes; vectors stack on the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

from vkr_ref.core.constants import constant

PI = 3.1415926535897932384626433832795


def fresnel_schlick(cos_theta, f0):
    """cos_theta: (...,), f0: (..., C) or (...,). Broadcasts over the
    trailing component axis if f0 has one."""
    c = (1.0 - cos_theta).clamp(0.0, 1.0) ** 5
    if f0.ndim > c.ndim:
        c = c[..., None]
    return f0 + (1.0 - f0) * c


def f0_approximation(albedo, metallic):
    """mix(0.04, albedo, metallic)."""
    base = torch.full_like(albedo, 0.04)
    m = metallic[..., None] if metallic.ndim < albedo.ndim else metallic
    return base + (albedo - base) * m


def distribution_ggx(n_dot_h, alpha):
    """GGX NDF, alpha-parameterized (brdf.glsl:31-38). Zero for back-facing.
    den is clamped away from 0 (noh == +-1 with alpha == 0 would be 0/0)."""
    alpha2 = alpha * alpha
    noh2 = n_dot_h * n_dot_h
    den = noh2 * alpha2 + (1.0 - noh2)
    den = torch.clamp(den * den, min=1e-12)
    return torch.where(noh2 > 0.0, alpha2, 0.0) / (PI * den)


def brdf_g1(alpha2, n_dot_v):
    """Smith G1 (brdf.glsl:42-46). ndv clamped away from 0 (0*inf = NaN
    under IEEE)."""
    ndv2 = torch.clamp(n_dot_v * n_dot_v, min=1e-8)
    tgv2 = (1.0 - ndv2) / ndv2
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha2 * tgv2))


def brdf_g2(n_dot_v, n_dot_l, alpha2):
    """Height-correlated Smith G2 (brdf.glsl:48-56). Grazing-angle inputs
    clamped away from 0 (see brdf_g1)."""
    ndv2 = torch.clamp(n_dot_v * n_dot_v, min=1e-8)
    ndl2 = torch.clamp(n_dot_l * n_dot_l, min=1e-8)
    l1 = torch.sqrt(1.0 + alpha2 * (1.0 - ndv2) / ndv2)
    l2 = torch.sqrt(1.0 + alpha2 * (1.0 - ndl2) / ndl2)
    return 2.0 / (l1 + l2)


def _fma(a, b, c):
    """a * b + c rounded once: exact in float64 for float32 operands (the
    product has at most 48 significant bits), then rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


def sample_ggx_vndf(ve, alpha_x, alpha_y, u1, u2):
    """Heitz 2018 GGX VNDF sampling (brdf.glsl:147-167).

    ve: view direction in tangent space (..., 3), z up. u1/u2: uniforms
    (tensors or floats). Returns the sampled microfacet normal (..., 3).

    Where ve.z <= 0 (the view below the surface) 1 - p1^2 - p2^2 cancels
    to rounding noise, and the square root of that noise decides the
    sample. So the three cancelling steps are written as fmas, the form
    XLA's CPU jit and GPU shader compilers give them, and cos/sin of the
    sample angle are taken in float64 and rounded once: the port then
    follows vkr_tpu's samples there instead of drawing its own noise.
    """
    vh = torch.stack(
        [alpha_x * ve[..., 0], alpha_y * ve[..., 1], ve[..., 2]], dim=-1
    )
    vh = vh / torch.linalg.vector_norm(vh, dim=-1, keepdim=True)

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    x_axis = constant([1.0, 0.0, 0.0], vh.device, vh.dtype)
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        x_axis.expand(vh.shape),
    )
    t2 = torch.linalg.cross(vh, t1, dim=-1)

    u1, u2 = (u.to(vh.device, vh.dtype) if isinstance(u, torch.Tensor)
              else torch.full((), u, dtype=vh.dtype, device=vh.device)
              for u in (u1, u2))
    r = torch.sqrt(u1)
    phi = (2.0 * PI * u2).double()
    p1 = r * torch.cos(phi).float()
    p2 = r * torch.sin(phi).float()
    s = 0.5 * (1.0 + vh[..., 2])
    one = torch.ones_like(p1)
    p2 = _fma(s, p2, (1.0 - s) * torch.sqrt(_fma(-p1, p1, one)))
    rad = torch.clamp(_fma(-p2, p2, _fma(-p1, p1, one)), min=0.0)
    nh = _fma(torch.sqrt(rad)[..., None], vh,
              p1[..., None] * t1 + p2[..., None] * t2)
    ne = torch.stack(
        [alpha_x * nh[..., 0], alpha_y * nh[..., 1],
         torch.clamp(nh[..., 2], min=0.0)], dim=-1
    )
    return ne / torch.linalg.vector_norm(ne, dim=-1, keepdim=True)


def halton(index, base):
    """Halton low-discrepancy sequence (advanced_ssr.cpp:8-21), scalar."""
    f = 1.0
    r = 0.0
    i = index
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton23_table(count: int):
    """(count, 2) float32 numpy table of (halton(i+1,2), halton(i+1,3))."""
    out = np.zeros((count, 2), dtype=np.float32)
    for i in range(count):
        out[i, 0] = halton(i + 1, 2)
        out[i, 1] = halton(i + 1, 3)
    return out
