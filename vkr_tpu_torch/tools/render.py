"""Headless render CLI — the app/frame-loop analog (reference main.cpp), as
vkr_tpu/tools/render.py has it.

Renders a scene through the full pass chain (G-buffer, hi-Z, SSR, GTAO,
shading, TAA) on the card, through the hand-written kernels, and writes a
PNG. --no-kernels renders vkr_tpu's use_pallas=False oracle frame instead
(frame.py's use_kernels=False). As vkr_tpu's render.py:138 jits the
frame with the state donated, the frames run through core/aot.py's
cached_jit: captured as a CUDA graph at the first frame, replayed after
(on the CPU, the frame itself); a replay that dropped bin pairs makes the
next frame capture anew at its view (core/aot.py:call_or_recapture),
where vkr_tpu's tool renders on. Examples:

    python -m vkr_tpu_torch.tools.render --scene colonnade --width 1920 \
        --height 1080 --frames 8 --out captures/frame.png
    VKR_PLATFORM=cpu python -m vkr_tpu_torch.tools.render \
        --scene colonnade --size 64 --frames 2 --dump-dag
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# The Suzanne and Fox presets read the reference renderer's glTF assets
# from the directory that VKR_ASSETS names (scene/assets.py).
from vkr_tpu_torch.scene.assets import ASSETS_ENV, asset_path  # noqa: F401

SCENE_PRESETS = {
    "suzanne": {
        "asset": "suzanne/Suzanne.gltf",
        "eye": (0.0, 0.3, 2.6),
        "center": (0.0, 0.0, 0.0),
    },
    "fox": {
        "asset": "fox/Fox.gltf",
        "eye": (0.0, 90.0, -220.0),
        "center": (0.0, 50.0, 0.0),
    },
    "colonnade": {
        "eye": (-8.0, 2.2, -2.0),
        "center": (4.0, 1.8, 0.5),
    },
}

SHOW = ("color", "albedo", "normal", "depth", "ao", "ssr", "velocity")


def load_preset(name: str, tex_size: int, columns: int = 8,
                native_sizes: bool = False):
    """(CompiledScene, preset) for a preset name or a .gltf path."""
    from vkr_tpu_torch.scene import colonnade_scene, load_scene

    preset = SCENE_PRESETS.get(name)
    if preset is None:
        preset = {"path": name, "eye": (0, 1, -3), "center": (0, 0, 0)}
    elif "asset" in preset:
        preset = dict(preset, path=asset_path(preset["asset"], name))
    if "path" not in preset:
        scene = colonnade_scene(columns=columns, tessellation=24,
                                tex_size=tex_size)
        return scene, preset
    return load_scene(preset["path"], tex_size=tex_size,
                      native_sizes=native_sizes), preset


def orbit_view(preset, i: int, orbit: float):
    """Frame i's view: the preset's eye turned by orbit * i radians about
    the y axis through its centre."""
    from vkr_tpu_torch.mathlib import look_at

    eye = np.asarray(preset["eye"], np.float32)
    center = np.asarray(preset["center"], np.float32)
    if orbit:
        ang = orbit * i
        rot = np.array(
            [[np.cos(ang), 0, -np.sin(ang)],
             [0, 1, 0],
             [np.sin(ang), 0, np.cos(ang)]], np.float32)
        eye = center + rot @ (eye - center)
    return look_at(eye, center, (0, -1, 0))


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="suzanne")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--tex-size", type=int, default=256)
    parser.add_argument("--native-sizes", action="store_true",
                        help="per-texture native resolution/aspect "
                             "(scene.cpp:104-161 parity mode)")
    parser.add_argument("--lut-size", type=int, default=256)
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--out", default="captures/frame.png")
    parser.add_argument("--dump-dag", action="store_true")
    parser.add_argument("--no-kernels", action="store_true",
                        help="the oracle frame: plain versions in place of "
                             "the kernels, the brute-force G-buffer")
    parser.add_argument("--no-ssr", action="store_true")
    parser.add_argument("--no-gtao", action="store_true")
    parser.add_argument("--no-taa", action="store_true")
    parser.add_argument("--show", default="color", choices=SHOW)
    parser.add_argument("--ssr-iters", type=int, default=None)
    parser.add_argument("--orbit", type=float, default=0.0,
                        help="radians/frame camera orbit (animates)")
    args = parser.parse_args(argv)

    if args.size:
        args.width = args.height = args.size

    from vkr_tpu_torch.core.platform import ensure_platform

    device = ensure_platform()
    print("backend:", device)
    import dataclasses

    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.aot import cached_jit, call_or_recapture
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.graph import PassGraph
    from vkr_tpu_torch.core.readback import save_png, to_host
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.passes.gbuffer import upload_scene

    cfg = RenderConfig(
        width=args.width, height=args.height,
        enable_ssr=not args.no_ssr, enable_gtao=not args.no_gtao,
        enable_taa=not args.no_taa,
    )
    if args.ssr_iters:
        cfg = dataclasses.replace(
            cfg, ssr=dataclasses.replace(cfg.ssr,
                                         max_iterations=args.ssr_iters))

    scene_cpu, preset = load_preset(args.scene, args.tex_size,
                                    native_sizes=args.native_sizes)
    print(f"scene: {scene_cpu.num_triangles} triangles, "
          f"{len(scene_cpu.positions)} vertices")
    scene = upload_scene(scene_cpu, device)
    ssr_res = build_ssr_resources(args.lut_size, device=device)
    use_kernels = not args.no_kernels

    def view_at(i):
        return orbit_view(preset, i, args.orbit)

    state = FrameState.initial(cfg.height, cfg.width, device)
    graph = PassGraph()
    view = prev_view = view_at(0)

    def frame_fn(s, st, c):
        return render_frame(s, st, c, ssr_res, cfg, use_kernels=use_kernels)

    synchronize(device)
    cam = camera_frame(cfg, view, prev_view, 0, device)
    if args.dump_dag:
        # vkr_tpu traces frame_fn under jax.eval_shape for the dump: here
        # one frame runs on a state of its own while the graph records
        with graph.recording():
            frame_fn(scene, FrameState.initial(cfg.height, cfg.width,
                                               device), cam)
        print(graph.dump())
    t0 = time.perf_counter()
    jitted = cached_jit("render_frame", frame_fn, (scene, state, cam),
                        donate_argnums=(1,))
    color, state, aux = call_or_recapture(jitted, scene, state, cam)
    synchronize(device)
    print(f"compile+first: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          "(kernel build, capture, first frame)")

    times = []
    for i in range(1, args.frames):
        prev_view, view = view, view_at(i)
        cam = camera_frame(cfg, view, prev_view, i, device)
        t0 = time.perf_counter()
        color, state, aux = call_or_recapture(jitted, scene, state, cam)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    if times:
        print(f"steady frame: {np.median(times) * 1e3:.2f} ms "
              f"(min {min(times) * 1e3:.2f})")

    gbuf = aux["gbuffer"]
    outputs = {
        "color": lambda: to_host(color),
        "albedo": lambda: to_host(gbuf.albedo[..., :3]),
        "normal": lambda: to_host(gbuf.normal),
        "depth": lambda: 1.0 - to_host(gbuf.depth),
        "ao": lambda: to_host(aux["ao"]),
        "ssr": lambda: to_host(aux["ssr"]),
        "velocity": lambda: np.abs(to_host(gbuf.velocity)) * 50,
    }
    img = outputs[args.show]()
    coverage = float(np.mean(to_host(gbuf.depth) < 1.0))
    print(f"coverage: {coverage:.3f}")
    save_png(img, args.out,
             srgb_encode=args.show in ("color", "albedo", "ssr"))
    print("saved", args.out)
    # a replay counts no launch: the capture's, per frame (None: eager)
    return {"coverage": coverage, "out": args.out,
            "steady_ms": float(np.median(times) * 1e3) if times else None,
            "launches_per_frame": getattr(jitted, "launches", None)}


if __name__ == "__main__":
    main()
