"""Utility passes (reference src/util_passes.{hpp,cpp} + the perlin shader;
vkr_tpu/passes/util_passes.py): perlin noise generation, mip-chain
generation, clears, blits, the channel-select backbuffer view
(backbuffer_subpass2 + the texdraw shader) and the direction stripes of
the 'rotations' program.

The two hashes fract(sin(x) * 43758.5453) multiply sin's last ulp by
43,758, so a hashed value depends on how sin rounds. As in ssr.py's
_shader_rand, sin is taken in float64 and rounded once, which no device's
float32 sin changes; vkr_tpu's float32 sin is not correctly rounded, so
the two packages part on a share of the hashed values (held under a stated
bound in tests/test_torch_aux_passes.py).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.passes.sampling import bilinear_sample, screen_uv_grid

CUDA = torch.device("cuda")


def _hash_fract(arg):
    """fract(sin(arg) * 43758.5453), sin in float64 rounded once."""
    s = torch.sin(arg.double()).float() * 43758.5453
    return s - torch.floor(s)


# ------------------------------------------------------------- perlin

_FIRST_OCTAVE = 3
_OCTAVES = 8
_PERSISTENCE = 0.6


def _lattice_noise(x, y):
    """perlin/shader.frag noise(): hash of integer lattice coords."""
    return 2.0 * _hash_fract(x * 12.9898 + y * 78.233) - 1.0


def _smooth_noise(x, y):
    c = _lattice_noise(x, y) / 4.0
    s = (
        _lattice_noise(x + 1, y) + _lattice_noise(x - 1, y)
        + _lattice_noise(x, y + 1) + _lattice_noise(x, y - 1)
    ) / 8.0
    d = (
        _lattice_noise(x + 1, y + 1) + _lattice_noise(x + 1, y - 1)
        + _lattice_noise(x - 1, y + 1) + _lattice_noise(x - 1, y - 1)
    ) / 16.0
    return c + s + d


def _cos_interp(a, b, t):
    f = (1.0 - torch.cos(t * math.pi)) * 0.5
    return a * (1.0 - f) + b * f


def _interp_noise(x, y):
    ix = torch.floor(x)
    iy = torch.floor(y)
    fx = x - ix
    fy = y - iy
    v1 = _smooth_noise(ix, iy)
    v2 = _smooth_noise(ix + 1, iy)
    v3 = _smooth_noise(ix, iy + 1)
    v4 = _smooth_noise(ix + 1, iy + 1)
    return _cos_interp(_cos_interp(v1, v2, fx), _cos_interp(v3, v4, fx), fy)


@register("perlin")
def gen_perlin_noise2d(height: int, width: int, scale: float = 30.0,
                       device=CUDA):
    """util_passes gen_perlin_noise2D: octaved value noise over uv*30, on
    `device` (the card unless the caller asks for another)."""
    uv = screen_uv_grid(height, width, device)
    x = scale * uv[..., 0]
    y = scale * uv[..., 1]
    total = torch.zeros((height, width), dtype=torch.float32, device=device)
    for i in range(_FIRST_OCTAVE, _OCTAVES + _FIRST_OCTAVE):
        freq = 2.0 ** i
        amp = _PERSISTENCE ** i
        total = total + _interp_noise(x * freq, y * freq) * amp
    return total


# -------------------------------------------------------- mips / blit

def _quad_mean(q):
    """The mean of each 2x2 quad of q (h2, 2, w2, 2[, C]), summed in the
    order vkr_tpu's reduce takes on XLA:CPU: pairwise where an output row
    (w2 x C values) is a power of two long, else texel by texel."""
    row = q.shape[2] * (q.shape[4] if q.ndim == 5 else 1)
    a, b = q[:, 0, :, 0], q[:, 0, :, 1]
    c, d = q[:, 1, :, 0], q[:, 1, :, 1]
    if row & (row - 1) == 0:
        return ((a + b) + (c + d)) / 4.0
    return (((a + b) + c) + d) / 4.0


def gen_mipmaps(img):
    """util_passes gen_mipmaps (blit chain): full 2x2-average mip pyramid,
    list ordered base first."""
    mips = [img]
    cur = img
    while min(cur.shape[:2]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        cur = _quad_mean(cur[: h2 * 2, : w2 * 2].reshape(
            (h2, 2, w2, 2) + cur.shape[2:]))
        mips.append(cur)
    return mips


def clear_color(height: int, width: int, value=(0.0, 0.0, 0.0, 0.0),
                device=CUDA):
    """util_passes clear_color."""
    return torch.tensor(value, dtype=torch.float32, device=device).expand(
        height, width, len(value))


def clear_depth(height: int, width: int, value: float = 1.0, device=CUDA):
    """util_passes clear_depth."""
    return torch.full((height, width), value, dtype=torch.float32,
                      device=device)


def blit_image(src, dst_height: int, dst_width: int):
    """util_passes blit_image: bilinear rescale to the target extent."""
    return bilinear_sample(src, screen_uv_grid(dst_height, dst_width,
                                               src.device))


# ----------------------------------------------- backbuffer / texdraw

class DrawTex(enum.IntEnum):
    """Channel-select flags (backbuffer_subpass2.hpp / texdraw shader)."""

    ShowAll = 0
    ShowR = 1
    ShowG = 2
    ShowB = 3
    ShowA = 4


@register("texdraw")
def backbuffer_draw(tex, height: int, width: int,
                    mode: DrawTex = DrawTex.ShowAll):
    """add_backbuffer_subpass analog: fullscreen textured draw with
    channel-select (texdraw/shader.frag:9-33). Returns (H, W, 3)."""
    if tex.ndim == 2:
        tex = tex[..., None]
    sampled = bilinear_sample(tex, screen_uv_grid(height, width, tex.device))
    c = sampled.shape[-1]

    def chan(i):
        i = min(i, c - 1)
        return sampled[..., i: i + 1].expand(height, width, 3)

    if mode == DrawTex.ShowAll:
        return sampled[..., :3] if c >= 3 else chan(0)
    return chan(int(mode) - 1)


@register("rotations")
def draw_directions(height: int, width: int, angle, device=CUDA):
    """DrawDirs debug compute (draw_directions.hpp + the 'rotations'
    program, shaders/rotations/rot.comp): hashed stripes constant along
    the direction `angle` (radians, a Python float), the reference's
    interactive direction-visualisation aid. Returns (H, W) float32 in
    [0, 1) on `device`."""
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    a = np.float32(angle)
    # float32 cos and sin of the angle, rounded once from float64
    cos_a = float(np.float32(math.cos(a)))
    sin_a = float(np.float32(math.sin(a)))
    c = -(x * cos_a + y * sin_a)
    return _hash_fract(c * 12.9898 + c * 78.233)  # rand2D((c, c))
