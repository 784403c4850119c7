"""The colonnade goldens (tests/goldens/colonnade_{color,albedo,ao}.png,
made by vkr_tpu on the CPU) held with the port: test_golden.py's case,
rendered by the port's render_frame on the CPU (its kernels' plain
versions), against the same PNGs with the same bar, > 40 dB PSNR.

The case: the 3-column colonnade (tessellation 10, 64^2 textures) at
128x128, SSR max_iterations 24, LUTs of 64, 3 frames from eye (-6, 2.2, -2)
towards (4, 1.8, 0.5)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def srgb(x):
    x = np.clip(np.asarray(x), 0, 1)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1 / 2.4) - 0.055)


def load_golden(name):
    """The PNG's RGB pixels / 255 through the port's decoder (which
    returns RGBA)."""
    from vkr_tpu_torch.scene.gltf import decode_png

    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return decode_png(f.read())[..., :3].astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def colonnade():
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.mathlib.transforms import look_at
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=128, height=128)
    cfg = dataclasses.replace(cfg, ssr=dataclasses.replace(
        cfg.ssr, max_iterations=24))
    scene = upload_scene(colonnade_scene(columns=3, tessellation=10,
                                         tex_size=64), "cpu")
    res = build_ssr_resources(64, device="cpu")
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    state = FrameState.initial(128, 128, "cpu")
    for i in range(3):
        color, state, aux = render_frame(
            scene, state, camera_frame(cfg, view, view, i, "cpu"), res, cfg)
    return {"colonnade_color.png": srgb(color.numpy()),
            "colonnade_albedo.png": srgb(aux["gbuffer"].albedo[..., :3]
                                         .numpy()),
            "colonnade_ao.png": aux["ao"].numpy()}


@pytest.mark.parametrize("name", ["colonnade_color.png",
                                  "colonnade_albedo.png",
                                  "colonnade_ao.png"])
def test_colonnade_golden(colonnade, name):
    img = colonnade[name]
    golden = load_golden(name)
    if golden.ndim == 3 and img.ndim == 2:
        img = np.repeat(img[..., None], golden.shape[-1], -1)
    assert img.shape == golden.shape
    p = psnr(img, golden)
    print(f"{name}: {p:.2f} dB")
    assert p > 40.0, f"{name}: PSNR {p:.1f} dB vs golden"
