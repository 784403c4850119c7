"""Parity measurement: the kernel frame against the oracle frame, per
G-buffer channel and final frame (PSNR), as vkr_tpu/tools/parity.py
measures its Pallas path against its jnp oracle.

The BASELINE configs call for PSNR >= 40 dB per pass against reference
renders; without a Vulkan device the measurable analog is the frame
through the hand-written kernels (use_kernels=True) against the oracle
frame (use_kernels=False: the brute-force G-buffer and the kernels' plain
versions). The normal channel stays below 40 dB between the two rasters
on both packages: the oracle raster is not K1. As vkr_tpu jits both
modes (vkr_tpu/tools/parity.py:67), each mode's frame goes through
core/aot.py's cached_jit (captured as CUDA graphs on the card, the state
donated).

    python -m vkr_tpu_torch.tools.parity --scene colonnade --size 256
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CHANNELS = ("albedo", "normal", "depth", "velocity", "material", "ao", "ssr",
            "color")


def psnr(a, b, peak=1.0):
    from vkr_tpu_torch.core.readback import to_host

    mse = float(np.mean((to_host(a).astype(np.float64)
                         - to_host(b).astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="suzanne")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--tex-size", type=int, default=128)
    parser.add_argument("--lut-size", type=int, default=128)
    parser.add_argument("--frames", type=int, default=3)
    args = parser.parse_args(argv)

    from vkr_tpu_torch.core.platform import ensure_platform

    device = ensure_platform()
    print("backend:", device)
    import dataclasses

    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.aot import cached_jit
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.mathlib import look_at
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.tools.render import load_preset

    cfg = RenderConfig(width=args.size, height=args.size)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=32))
    scene_cpu, preset = load_preset(args.scene, args.tex_size)
    scene = upload_scene(scene_cpu, device)
    ssr_res = build_ssr_resources(args.lut_size, device=device)
    view = look_at(preset["eye"], preset["center"], (0, -1, 0))

    outs = {}
    for mode, use_kernels in (("kernels", True), ("oracle", False)):
        state = FrameState.initial(cfg.height, cfg.width, device)
        frame = cached_jit(
            f"parity {mode}",
            lambda s, st, c, uk=use_kernels: render_frame(
                s, st, c, ssr_res, cfg, use_kernels=uk),
            (scene, state, camera_frame(cfg, view, view, 0, device)),
            donate_argnums=(1,))
        for i in range(args.frames):
            cam = camera_frame(cfg, view, view, i, device)
            color, state, aux = frame(scene, state, cam)
        g = aux["gbuffer"]
        outs[mode] = dict(
            albedo=g.albedo, normal=g.normal, depth=g.depth,
            velocity=g.velocity, material=g.material,
            ao=aux["ao"], ssr=aux["ssr"], color=color,
        )

    results = {key: round(psnr(outs["kernels"][key], outs["oracle"][key]), 2)
               for key in CHANNELS}
    print(json.dumps({"psnr_kernels_vs_oracle_db": results}))
    return results


if __name__ == "__main__":
    main()
