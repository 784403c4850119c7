"""SSR resources — so far only the split-sum BRDF LUT that deferred shading
reads even with SSR off (frame.py). The SSR trace/filter/blur passes and
the PDF LUT are the next slice (ROADMAP queue 1 items 5-6).

Reference: shaders/advanced_ssr/preintegrate_ssr.comp; vkr_tpu/passes/ssr.py.
"""

from __future__ import annotations

import torch

from vkr_tpu_torch.mathlib.brdf import (
    brdf_g1,
    brdf_g2,
    halton23_table,
    sample_ggx_vndf,
)

HALTON_SEQ_SIZE = 128  # advanced_ssr.cpp:6


def preintegrate_brdf(size: int = 1024, num_samples: int = 128,
                      device="cpu"):
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
        l = l / torch.linalg.vector_norm(l, dim=-1,
                                         keepdim=True).clamp(min=1e-20)
        ndl = l[..., 2]
        alpha = (1.0 - vdh) ** 5
        g2 = brdf_g2(ndv * ones, ndl, r2)
        ratio = g2 / torch.clamp(g1, min=1e-20)
        a_sum = a_sum + ratio * (1.0 - alpha)
        b_sum = b_sum + ratio * alpha
    return torch.stack([a_sum / num_samples, b_sum / num_samples], dim=-1)
