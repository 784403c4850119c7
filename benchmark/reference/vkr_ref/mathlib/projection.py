"""Depth / view-space reconstruction helpers.

Same math as the reference's shaders/include/gbuffer_encode.glsl:58-93:
the renderer stores hardware depth d in [0,1] (reverse of linear view z,
which is negative in front of the camera with the RH projection) and
reconstructs view-space positions from (uv, d).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _tan_half(fovy: float) -> float:
    """tan(fovy / 2) rounded to float32, the precision the passes use."""
    return float(np.float32(math.tan(fovy / 2.0)))


def linearize_depth(d, znear, zfar):
    """Hardware depth [0,1] -> view-space z (negative in front of camera).

    gbuffer_encode.glsl:52-55 (linearize_depth2).
    """
    return znear * zfar / (d * (zfar - znear) - zfar)


def encode_depth(z, znear, zfar):
    """View-space z (negative) -> hardware depth [0,1].

    gbuffer_encode.glsl:75-77 (encode_depth). The quotient is a true
    division: torch's scalar / tensor multiplies by the reciprocal, an ulp
    off vkr_tpu's on some depths.
    """
    z = torch.as_tensor(z)
    return zfar / (zfar - znear) + torch.div(zfar * znear,
                                             z * (zfar - znear))


def reconstruct_view_vec(uv, d, fovy, aspect, znear, zfar):
    """(uv in [0,1]^2 with stacked last axis, depth) -> view-space position.

    gbuffer_encode.glsl:57-69. uv: (..., 2), d: (...,) -> (..., 3).
    """
    tg = _tan_half(fovy)
    z = linearize_depth(d, znear, zfar)
    xd = 2.0 * uv[..., 0] - 1.0
    yd = 2.0 * uv[..., 1] - 1.0
    x = -xd * (z * aspect * tg)
    y = -yd * (z * tg)
    return torch.stack([x, y, z], dim=-1)


def project_view_vec(v, fovy, aspect, znear, zfar):
    """View-space position (..., 3) -> (u, v, depth) in [0,1].

    gbuffer_encode.glsl:79-90.
    """
    tg = _tan_half(fovy)
    z = v[..., 2]
    depth = zfar / (zfar - znear) + zfar * znear / (z * (zfar - znear))
    pu = v[..., 0] / (-z * tg * aspect)
    pv = v[..., 1] / (-z * tg)
    return torch.stack([0.5 * pu + 0.5, 0.5 * pv + 0.5, depth], dim=-1)
