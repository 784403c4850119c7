"""Legacy SSAO pass (src/ssao.{hpp,cpp} + shaders/ssao/shader.frag).

The port of vkr_tpu/passes/ssao.py. The reference's main loop runs GTAO
instead, but SSAO is part of its component inventory (BASELINE.json
config 2 is "GTAO + SSAO"). Per pixel, 16 unit-sphere samples scaled by
0.05 around the reconstructed view position, each projected back to the
screen and depth-compared.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vkr_tpu_torch.core.registry import register
from vkr_tpu_torch.mathlib.projection import reconstruct_view_vec
from vkr_tpu_torch.passes.sampling import bilinear_sample, screen_uv_grid

SAMPLE_COUNT = 16


def sphere_samples(seed: int = 0) -> np.ndarray:
    """Rejection-sampled unit sphere directions (ssao.cpp:33-48), from
    vkr_tpu's seeded numpy generator: the same (16, 3) float32 table."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < SAMPLE_COUNT:
        v = rng.uniform(-1, 1, 3)
        l2 = float(v @ v)
        if l2 < 1.0 and l2 > 1e-12:
            out.append(v / np.sqrt(l2))
    return np.asarray(out, np.float32)


class SSAOParams(NamedTuple):
    projection: torch.Tensor  # (4,4)
    fovy: float
    aspect: float
    znear: float
    zfar: float


@register("ssao")
def ssao(depth, params: SSAOParams, samples=None):
    """(H, W) depth -> (H, W) occlusion in [0,1] (1 = unoccluded).

    The projection of each sample point is written out as float32
    products and sums, so no TF32 matmul setting can reach it."""
    if samples is None:
        samples = sphere_samples()
    samples = torch.as_tensor(samples, dtype=torch.float32,
                              device=depth.device)
    h, w = depth.shape
    uv = screen_uv_grid(h, w, depth.device)
    camera_pos = reconstruct_view_vec(uv, depth, params.fovy, params.aspect,
                                      params.znear, params.zfar)
    proj = params.projection
    acc = torch.zeros_like(depth)
    for i in range(SAMPLE_COUNT):
        pos = camera_pos + 0.05 * samples[i]
        # [pos, 1] @ proj.T
        ph = ((pos[..., 0:1] * proj[:, 0] + pos[..., 1:2] * proj[:, 1])
              + pos[..., 2:3] * proj[:, 2]) + proj[:, 3]
        ndc = ph[..., :3] / torch.where(ph[..., 3:4].abs() < 1e-20, 1e-20,
                                        ph[..., 3:4])
        sample_uv = 0.5 * ndc[..., :2] + 0.5
        sample_depth = bilinear_sample(depth, sample_uv)
        acc = acc + torch.where(ndc[..., 2] < sample_depth + 1e-7, 1.0, 0.0)
    return acc / SAMPLE_COUNT
