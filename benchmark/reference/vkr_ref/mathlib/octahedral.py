"""Octahedral direction/normal encodings.

Same math as the reference's shaders/include/gbuffer_encode.glsl:17-37
(normal <-> RG16_UNORM payload) and shaders/include/octahedral.glsl (probe
direction <-> octahedral texel), vectorized over tensors with an arbitrary
leading shape and a trailing component axis.
"""

from __future__ import annotations

import torch


def _sign_nz(v):
    """sign() that maps 0 to +1 (gbuffer_encode.glsl:5-7)."""
    return torch.where(v >= 0.0, 1.0, -1.0)


def encode_normal(n):
    """Unit vector (..., 3) -> octahedral uv in [0,1]^2 (..., 2)."""
    l1 = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    xy = n[..., :2] / l1[..., None]
    # Lower hemisphere: fold over the diagonal.
    folded = (1.0 - xy.flip(-1).abs()) * _sign_nz(xy)
    xy = torch.where((n[..., 2] < 0.0)[..., None], folded, xy)
    return 0.5 * xy + 0.5


def decode_normal(uv):
    """Octahedral uv in [0,1]^2 (..., 2) -> unit vector (..., 3)."""
    uv = 2.0 * uv - 1.0
    z = 1.0 - uv[..., 0].abs() - uv[..., 1].abs()
    folded = (1.0 - uv.flip(-1).abs()) * _sign_nz(uv)
    xy = torch.where((z < 0.0)[..., None], folded, uv)
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


# Probe-space octahedral direction mapping (octahedral.glsl oct_encode /
# oct_decode): the same folding under the probe shaders' names.
oct_encode_dir = encode_normal
oct_decode_dir = decode_normal
