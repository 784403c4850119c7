"""Per-pass wall-clock profiler (the RenderDoc-label analog, SURVEY.md
§5.1), as vkr_tpu/tools/profile.py times its passes: each of the frame's
ten passes runs standalone on one G-buffer of the colonnade. As vkr_tpu
jits each pass on its own, each goes through core/aot.py's cached_jit
(nothing donated): its first call captures it into CUDA graphs, printed
as the capture's seconds in vkr_tpu's "(compile ...s)" place, and --reps
replays follow, bracketed by torch.cuda.synchronize(). On the CPU
cached_jit hands each pass back and the passes run eagerly. --scene
sponza profiles bench.py's default workload instead
(sponza_colonnade_scene(columns=24, tessellation=80), Sponza's textures
read from $VKR_ASSETS).

    python -m vkr_tpu_torch.tools.profile --width 1920 --height 1080
    VKR_ASSETS=<assets/gltf> python -m vkr_tpu_torch.tools.profile \
        --scene sponza --tex-size 512
"""

from __future__ import annotations

import argparse
import time

PASSES = ("gbuffer", "hiz", "ssr_trace", "ssr_filter", "ssr_blur",
          "gtao_window", "gtao_filter", "gtao_accum", "shading", "taa")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="colonnade",
                        choices=["colonnade", "sponza"])
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--columns", type=int, default=16)
    parser.add_argument("--tessellation", type=int, default=64)
    parser.add_argument("--tex-size", type=int, default=512)
    parser.add_argument("--lut-size", type=int, default=1024)
    parser.add_argument("--ssr-iters", type=int, default=80)
    parser.add_argument("--reps", type=int, default=8)
    return parser.parse_args(argv)


def run_passes(args, device, run) -> None:
    """The ten passes in PASSES order on `device`: each is handed to
    run(name, fn, fn_args), whose result (fn(*fn_args), or what a capture
    of fn returns) feeds the passes after it. The scene, the LUTs and the
    pyramid that the passes close over live until the last pass returns.
    The python scalars among the arguments (ssr_trace's frame 0,
    gtao_window's base angle 0.3, gtao_accum's clear flag) reach the
    passes' float32 arithmetic as a 0-d float32 tensor would: vkr_tpu
    passes jnp.asarray(0.3)."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (_inv4, _normal_mat4,
                                     build_ssr_resources, camera_frame)
    from vkr_tpu_torch.mathlib import look_at
    from vkr_tpu_torch.passes import gtao as G
    from vkr_tpu_torch.passes import ssr as S
    from vkr_tpu_torch.passes import taa as T
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.passes.shading import ShadingParams, deferred_shading
    from vkr_tpu_torch.scene import colonnade_scene
    from vkr_tpu_torch.scene.procedural import sponza_colonnade_scene

    W, H = args.width, args.height
    cfg = RenderConfig(width=W, height=H)
    if args.scene == "sponza":
        scene_cpu = sponza_colonnade_scene(columns=24, tessellation=80,
                                           tex_size=args.tex_size)
    else:
        scene_cpu = colonnade_scene(columns=args.columns,
                                    tessellation=args.tessellation,
                                    tex_size=args.tex_size)
    scene = upload_scene(scene_cpu, device)
    res = build_ssr_resources(args.lut_size, device=device)
    view = look_at((-18, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    cam = camera_frame(cfg, view, view, 0, device)
    state = FrameState.initial(H, W, device)

    lens = dict(fovy=cfg.camera.fovy, aspect=cfg.aspect,
                znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    gb = run("gbuffer", lambda c: render_gbuffer(
        scene, c.mvp, c.prev_mvp, c.jitter, width=W, height=H), (cam,))
    hiz = run("hiz", build_hiz, (gb.depth, gb.normal, gb.velocity))
    dh = hiz.mips[0]
    nm = _normal_mat4(cam.view)
    inv = _inv4(cam.view)
    sp = S.SSRParams(normal_mat=nm, **lens)
    pyr = S.pack_pyramid(hiz.mips)
    tr = run("ssr_trace", lambda nh, mat, fr: S.ssr_trace(
        pyr, nh, mat, res.pdf_lut, sp, fr, res.halton,
        max_iterations=args.ssr_iters), (hiz.normal_half, gb.material, 0))
    refl = run("ssr_filter", lambda r, d, a, nh, m: S.ssr_filter(
        r, d, a, nh, m, sp), (tr[0], dh, gb.albedo, hiz.normal_half,
                              gb.material))
    bp = S.SSRBlurParams(inverse_camera=inv, prev_inverse_camera=inv,
                         **lens)
    run("ssr_blur", lambda *a: S.ssr_blur(*a, bp), (
        refl, dh, hiz.normal_half, gb.material, state.ssr_history,
        hiz.velocity_half, state.prev_depth_half))
    gp = G.GTAOParams(normal_mat=nm, **lens)
    raw = run("gtao_window", lambda d, nh, b: G.gtao_main_window(
        d, nh, gp, b), (dh, hiz.normal_half, 0.3))
    filt = run("gtao_filter", lambda d, r: G.gtao_filter(
        d, r, cfg.camera.znear, cfg.camera.zfar), (dh, raw))
    ap = G.GTAOAccumParams(inverse_camera=inv, prev_inverse_camera=inv,
                           mvp=cam.mvp, **lens)
    acc = run("gtao_accum", lambda *a: G.gtao_accumulate(*a, ap, False), (
        dh, state.prev_depth_half, filt, hiz.velocity_half,
        state.gtao_accum))
    shp = ShadingParams(inverse_camera=inv, **lens)
    col = run("shading", lambda g, o, r, pd: deferred_shading(
        g, shp, occlusion=o, reflections=r, brdf_lut=res.brdf_lut,
        depth_half=pd), (gb, acc[..., 0], state.ssr_history, dh))
    tp = T.TAAParams(inverse_camera=inv, prev_inverse_camera=inv, **lens)
    run("taa", lambda *a: T.taa_resolve(*a, tp), (
        state.taa_history, state.prev_depth, gb.depth, gb.velocity, col))


def main(argv=None):
    """Prints the backend, then one line per pass (its name first, in
    PASSES order: the mean ms of --reps calls, and the first call's
    seconds, a capture on the card); on the card, the allocator's reserve
    with the ten captures alive. Returns {pass name: mean ms}. Each pass
    is timed to its end before the next is captured on its outputs: a
    replay of an earlier pass would overwrite what a later one reads."""
    args = parse_args(argv)

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.platform import ensure_platform
    from vkr_tpu_torch.tools.render import synchronize

    device = ensure_platform()
    print("backend:", device)
    times, calls = {}, []

    def bench(name, f, a):
        synchronize(device)
        t0 = time.perf_counter()
        call = aot.cached_jit(name, f, a)
        calls.append(call)  # every capture lives until the reserve's read
        out = call(*a)
        synchronize(device)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = call(*a)
        synchronize(device)
        times[name] = (time.perf_counter() - t0) / args.reps * 1e3
        what = "capture" if isinstance(call, aot.CapturedFrame) else "first"
        print(f"{name:22s} {times[name]:9.2f} ms   ({what} {first:.3f} s)",
              flush=True)
        return out

    run_passes(args, device, bench)
    if device.type == "cuda":
        import torch

        held = sum(isinstance(c, aot.CapturedFrame) for c in calls)
        print(f"allocator reserve after the last pass ({held} captures): "
              f"{torch.cuda.memory_reserved(device)} bytes", flush=True)
    return times


if __name__ == "__main__":
    main()
