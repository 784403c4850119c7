"""Showcase capture: dolly through the colonnade on the card and write
<out-dir>/colonnade_orbit.gif and <out-dir>/colonnade_final.png (the
converged still), as vkr_tpu/tools/showcase.py writes its docs/ images.

    python -m vkr_tpu_torch.tools.showcase --out-dir captures

The dolly, the frame count (72 at 1920x1080, the first 8 skipped while
TAA and SSR converge, every 2nd frame kept) and the GIF (a third of the
frame size, 640x360 at the default, LANCZOS, 66 ms per frame, looping) are
vkr_tpu's. As vkr_tpu jits the frame with the state donated
(vkr_tpu/tools/showcase.py:25), the frames go through core/aot.py's
cached_jit: captured as CUDA graphs at the first frame, replayed after,
and captured anew at the current view after a replay that dropped bin
pairs (core/aot.py:call_or_recapture). The downscale and the GIF writer
are core/readback's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

SKIP = 8          # frames rendered before the capture starts
DOLLY_END = 56    # the camera holds still from this frame on
DURATION_MS = 66
# the scene: vkr_tpu's 16-column, 64-segment hall with 512² textures and a
# 1024² SSR LUT
COLUMNS = 16
TESSELLATION = 64
TEX_SIZE = 512
LUT_SIZE = 1024


def view_at(i: int):
    """Frame i's view: a slow dolly down the hall, still for the last
    frames so the temporal passes converge for the final still."""
    from vkr_tpu_torch.mathlib import look_at

    eye = np.array([-18.0, 2.2, -2.0], np.float32)
    center = np.array([4.0, 1.8, 0.5], np.float32)
    t = min(i, DOLLY_END)
    e = eye + np.array([0.12 * t, 0.0, 0.3 * np.sin(0.05 * t)], np.float32)
    c = center + np.array([0.12 * t, 0.0, 0.0], np.float32)
    return look_at(e, c, (0, -1, 0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out-dir", default="captures")
    parser.add_argument("--frames", type=int, default=72)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    args = parser.parse_args(argv)

    from vkr_tpu_torch.core.platform import ensure_platform

    device = ensure_platform()
    print("backend:", device)
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.aot import cached_jit, call_or_recapture
    from vkr_tpu_torch.core.formats import linear_to_srgb
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.readback import (gif_bytes, lanczos_resize,
                                             png_bytes, to_host)
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import colonnade_scene

    w, h = args.width, args.height
    cfg = RenderConfig(width=w, height=h)
    scene = upload_scene(colonnade_scene(columns=COLUMNS,
                                         tessellation=TESSELLATION,
                                         tex_size=TEX_SIZE), device)
    res = build_ssr_resources(LUT_SIZE, device=device)

    state = FrameState.initial(h, w, device)
    view = view_at(0)
    render = cached_jit(
        "showcase", lambda s, st, c: render_frame(s, st, c, res, cfg),
        (scene, state, camera_frame(cfg, view, view, 0, device)),
        donate_argnums=(1,))
    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        prev, view = view, view_at(i)
        cam = camera_frame(cfg, view, prev, i, device)
        color, state, _ = call_or_recapture(render, scene, state, cam)
        if i >= SKIP:
            frames.append(np.clip(to_host(linear_to_srgb(color)) * 255, 0,
                                  255).astype(np.uint8))
    render_s = time.perf_counter() - t0
    print(f"{args.frames} frames in {render_s:.1f}s", flush=True)
    if not frames:
        raise ValueError(f"--frames {args.frames}: the first {SKIP} frames "
                         "are not captured")
    os.makedirs(args.out_dir, exist_ok=True)
    final = os.path.join(args.out_dir, "colonnade_final.png")
    with open(final, "wb") as f:
        f.write(png_bytes(frames[-1], colour_type=2))
    small = [lanczos_resize(fr, w // 3, h // 3) for fr in frames[::2]]
    gif = os.path.join(args.out_dir, "colonnade_orbit.gif")
    with open(gif, "wb") as f:
        f.write(gif_bytes(np.stack(small), DURATION_MS, loop=0))
    print(f"saved {gif} + {len(small)} frames, {final}", flush=True)
    return {"gif": gif, "final": final, "frames": small,
            "render_s": render_s}


if __name__ == "__main__":
    main()
