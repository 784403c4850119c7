"""Storage-format emulation.

The reference renders into typed Vulkan images — RGBA8_SRGB albedo/material,
RG16_UNORM octahedral normals, RG16F velocity, D24 depth
(scene_renderer.cpp:15-27). Every render target here is a float32 tensor;
to match the reference's precision at pass boundaries the G-buffer
round-trips values through the same quantization the formats would apply.
"""

from __future__ import annotations

import torch


def quantize_unorm(x, bits: int):
    """Round-trip through a bits-wide UNORM encoding ([0,1] clamped).
    torch.round rounds half to even, as the reference's jnp.round does."""
    scale = float((1 << bits) - 1)
    return torch.round(x.clamp(0.0, 1.0) * scale) / scale


def quantize_f16(x):
    """Round-trip through IEEE half precision (RG16F targets)."""
    return x.to(torch.float16).to(torch.float32)


def srgb_to_linear(c):
    """sRGB EOTF (what sampling an SRGB image does in hardware)."""
    c = c.clamp(0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    """Inverse EOTF (what writing to an SRGB attachment does)."""
    c = c.clamp(0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055
    )
