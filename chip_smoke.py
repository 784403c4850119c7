#!/usr/bin/env python3
"""Smoke run of vkr_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Needs a CUDA card (exits 1 without one) and prints nvidia-smi's name and
   power limit of the card.
2. Builds the hand-written CUDA kernels (vkr_tpu_torch/csrc, nvcc into
   vkr_tpu_torch/build/) and prints the build seconds.
3. Frame phase: renders 8 frames of the bench orbit at 1920x1080 on the
   procedural colonnade (columns=24, tessellation=80, tex_size=1024:
   314,988 triangles, 96 alpha-MASK) with the default RenderConfig and SSR
   off. Launch counters are cleared just before and read just after; every
   kernel must have launched (per frame at least K1 x3, K4 x1, K5 x2,
   K6 x1). Fails unless each frame covers >= 98% of the pixels, drops no
   bin pair and is finite. Prints the median frame time (synchronised host
   clock, the first two frames excluded as warm-up).
4. Kernel phase: every kernel call of frame 1, captured with its inputs, is
   run again through the kernel and through its plain PyTorch version on
   the card; each pair must agree within the stated tolerance. Prints both
   times (CUDA events).
5. Renders the same 8 frames with the plain versions substituted for the
   kernels, and requires >= 40 dB PSNR on every G-buffer channel, the AO
   and the final colour of every frame.
6. Prints one JSON line {"kernels": [...]} and, last, the line
   {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8
WARMUP_FRAMES = 2
CAPTURE_FRAME = 1
SCENE = dict(columns=24, tessellation=80, tex_size=1024)
SCENE_TRIANGLES, SCENE_MASKED = 314_988, 96
MIN_COVERAGE = 0.98
MIN_PSNR_DB = 40.0
FRAME_CHANNELS = ("albedo", "normal", "material", "velocity", "depth", "ao",
                  "color")
SLEEP_CYCLES_PER_S = 2e9  # about the H100's SM clock (1.98 GHz boost)
MIN_LAUNCHES_PER_FRAME = {"gbuf_tiles": 3, "window_gather_bilinear_multi": 1,
                          "window_gather_bilinear": 2,
                          "taa_history_gather": 1}

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "gbuf_tiles": ("vkr_tpu_torch/csrc/gbuf_tiles.cu",
                   "vkr_tpu/raster/gbuf_kernel.py:41"),
    "window_gather_bilinear_multi": ("vkr_tpu_torch/csrc/window_gather.cu",
                                     "vkr_tpu/raster/gather_kernel.py:192"),
    "window_gather_bilinear": ("vkr_tpu_torch/csrc/window_gather.cu",
                               "vkr_tpu/raster/gather_kernel.py:56"),
    "taa_history_gather": ("vkr_tpu_torch/csrc/window_gather.cu",
                           "vkr_tpu/raster/gather_kernel.py:333"),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def plain_versions():
    """kernel wrapper name -> (module, its plain PyTorch version)."""
    from vkr_tpu_torch.raster import gather_kernel, gbuf_kernel

    return {
        "gbuf_tiles": (gbuf_kernel, gbuf_kernel.gbuf_tiles_reference),
        "window_gather_bilinear_multi": (
            gather_kernel, gather_kernel.window_gather_multi_reference),
        "window_gather_bilinear": (gather_kernel,
                                   gather_kernel.window_gather_reference),
        "taa_history_gather": (gather_kernel,
                               gather_kernel.taa_history_gather_reference),
    }


class Substitute:
    """Swap each kernel wrapper in its module (the passes call them through
    the module) for another function while the block runs."""

    def __init__(self, make):
        self.make = make  # (name, wrapper, plain) -> function
        self.saved = {}

    def __enter__(self):
        for name, (mod, plain) in plain_versions().items():
            self.saved[name] = (mod, getattr(mod, name))
            setattr(mod, name, self.make(name, getattr(mod, name), plain))
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.saved.items():
            setattr(mod, name, fn)


def recording(log):
    """Substitute factory: call the kernel, keeping a copy of its inputs."""
    import torch

    def make(name, wrapper, plain):
        def rec(*args, **kw):
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            log.append((name, kept, dict(kw)))
            return wrapper(*args, **kw)
        return rec
    return make


def render(scene, res, cfg, device, on_frame=None):
    """The bench loop (bench.py): frame i sees orbit view i after view i-1.
    Returns per-frame outputs, per-frame seconds and per-frame overflow."""
    import torch

    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    state = FrameState.initial(HEIGHT, WIDTH, device)
    outs, secs = [], []
    for i in range(N_FRAMES):
        cam = camera_frame(cfg, bench_orbit_view(i),
                           bench_orbit_view(max(i - 1, 0)), i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on_frame is not None:
            with on_frame(i):
                color, state, aux = render_frame(scene, state, cam, res, cfg)
        else:
            color, state, aux = render_frame(scene, state, cam, res, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        g = aux["gbuffer"]
        out = {k: getattr(g, k) for k in FRAME_CHANNELS[:5]}
        out.update(ao=aux["ao"], color=color, overflow=int(aux["overflow"]))
        outs.append(out)
    return outs, secs


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def time_ms(fn, args, kw, budget_s=0.5):
    """Mean milliseconds of fn(*args, **kw) on the card: one warm-up call,
    then as many calls as fit the budget (1..50), timed by CUDA events.

    The stream is first held by a device-side sleep about as long as the
    host needs to enqueue the calls, so a kernel shorter than its launch
    overhead is timed on the device and not at the host's launch rate. A
    call that synchronises (a plain version may) still counts its gaps."""
    import torch

    fn(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args, **kw)
    torch.cuda.synchronize()
    one_s = max(time.perf_counter() - t0, 1e-6)
    reps = max(1, min(50, int(budget_s / one_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(reps * one_s, 0.1) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want):
    """(max abs error, within tolerance) of a kernel's outputs against its
    plain version's.

    K1: depth and triangle id equal (the same fma-form plane evaluation
    and the same d <= z walk), attributes within 1e-6 + 1e-6 |x| (a
    float64-emulated fma may round differently from fmaf on a float32
    tie). K4/K5/K6: the same clamp/floor/lerp sequence in float32 without
    contraction, atol 1e-6."""
    import torch

    if name == "gbuf_tiles":
        (z, tid, attrs), (z0, tid0, attrs0) = got, want
        err = max(float((z - z0).abs().max()),
                  float((attrs - attrs0).abs().max()))
        ok = (torch.equal(z, z0) and torch.equal(tid, tid0)
              and bool(((attrs - attrs0).abs()
                        <= 1e-6 + 1e-6 * attrs0.abs()).all()))
        return err, ok
    err = float((got - want).abs().max())
    return err, err <= 1e-6


def shape_of(name, args, kw):
    if name == "gbuf_tiles":
        return (f"{kw['tile_h']}x{kw['tile_w']} tiles, "
                f"{int(args[2].sum())} pairs"
                + (", peel" if args[3] is not None else ""))
    return " ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    build_s = kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    print(f"build: {build_s:.2f} s ({', '.join(kernels.SOURCES)})")

    t0 = time.perf_counter()
    scene_np = colonnade_scene(**SCENE)
    scene = upload_scene(scene_np, device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, enable_ssr=False)
    res = build_ssr_resources(cfg.ssr.lut_size, device=device)
    torch.cuda.synchronize()
    n_tri = len(scene.tri_opaque_mat) + len(scene.tri_masked_mat)
    print(f"scene: {n_tri} triangles ({len(scene.tri_masked_mat)} "
          f"alpha-MASK), BRDF LUT {cfg.ssr.lut_size}^2, "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_tri == SCENE_TRIANGLES and
          len(scene.tri_masked_mat) == SCENE_MASKED,
          f"scene has {n_tri} triangles, expected {SCENE_TRIANGLES}")

    # ---- frame phase: the main path, through the kernels ----
    captured = []

    def capture(i):
        return (Substitute(recording(captured)) if i == CAPTURE_FRAME
                else contextlib.nullcontext())

    kernels.LAUNCHES.clear()
    outs, secs = render(scene, res, cfg, device, on_frame=capture)
    launches = dict(kernels.LAUNCHES)
    for i, o in enumerate(outs):
        cov = float((o["depth"] < 1.0).float().mean())
        check(cov >= MIN_COVERAGE, f"frame {i}: coverage {cov:.4f}")
        check(o["overflow"] == 0, f"frame {i}: {o['overflow']} bin pairs "
              "dropped")
        for k in FRAME_CHANNELS:
            check(bool(torch.isfinite(o[k]).all()), f"frame {i}: {k} is "
                  "not finite")
        check(tuple(o["color"].shape) == (HEIGHT, WIDTH, 3),
              f"frame {i}: colour shape {tuple(o['color'].shape)}")
    for name, per_frame in MIN_LAUNCHES_PER_FRAME.items():
        check(launches.get(name, 0) >= per_frame * N_FRAMES,
              f"{name} launched {launches.get(name, 0)} times in "
              f"{N_FRAMES} frames")
    median_ms = statistics.median(s * 1e3 for s in secs[WARMUP_FRAMES:])
    print(f"frames: {N_FRAMES} at {WIDTH}x{HEIGHT}, coverage "
          f"{min(float((o['depth'] < 1.0).float().mean()) for o in outs):.4f}"
          f" (min), overflow 0, launches {launches}")
    print(f"frame ms: median {median_ms:.3f} over frames "
          f"{WARMUP_FRAMES}..{N_FRAMES - 1} "
          f"{[round(s * 1e3, 3) for s in secs[WARMUP_FRAMES:]]}; warm-up "
          f"{[round(s * 1e3, 3) for s in secs[:WARMUP_FRAMES]]}")

    # ---- kernel phase: frame 1's kernel calls against the plain versions
    plain = plain_versions()
    wrappers = {name: getattr(mod, name) for name, (mod, _) in plain.items()}
    results = {}
    failures = []
    for name, args, kw in captured:
        got = wrappers[name](*args, **kw)
        want = plain[name][1](*args, **kw)
        torch.cuda.synchronize()
        err, ok = compare(name, got, want)
        ms = time_ms(wrappers[name], args, kw)
        plain_ms = time_ms(plain[name][1], args, kw)
        case = {"shape": shape_of(name, args, kw), "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms}
        results.setdefault(name, []).append(case)
        print(f"kernel {name} [{case['shape']}]: max_abs_err {err:.3g} "
              f"({'ok' if ok else 'OUT OF TOLERANCE'}), {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if not ok:
            failures.append(f"{name} [{case['shape']}] max_abs_err {err}")
    check(not failures, "kernel disagrees with its plain version: "
          + "; ".join(failures))
    for name in KERNELS:
        check(name in results, f"{name} was not called in frame "
              f"{CAPTURE_FRAME}")

    # ---- the same frames through the plain versions ----
    kernels.LAUNCHES.clear()
    with Substitute(lambda name, wrapper, p: p):
        plain_outs, plain_secs = render(scene, res, cfg, device)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {}
    for i, (o, p) in enumerate(zip(outs, plain_outs)):
        for k in FRAME_CHANNELS:
            worst[k] = min(worst.get(k, math.inf), psnr(o[k], p[k]))
    print("psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    plain_median_ms = statistics.median(
        s * 1e3 for s in plain_secs[WARMUP_FRAMES:])
    print(f"plain-version frame ms: median {plain_median_ms:.3f} over "
          f"frames {WARMUP_FRAMES}..{N_FRAMES - 1}")
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"{k}: {v:.2f} dB against the plain "
              f"versions (< {MIN_PSNR_DB})")

    table = []
    for name, (source, replaces) in KERNELS.items():
        cases = results[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # per frame: the sum over the frame's calls of this kernel
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
