#!/usr/bin/env python3
"""Card check of vkr_tpu_torch on one CUDA card: each phase below fails
on a wrong result, and the last line is printed only when all pass.

    python3 chip_smoke.py

It times no frame: frame times are the benchmark's (benchmark/run.py;
--trace 1 splits the frame by segment and by pass). What it times is each
kernel alone, beside its plain version and its bound (phase 15), and the
seconds of start-up and of the tools. Most phases render the bench orbit
at 1920x1080 on the procedural colonnade (columns=24, tessellation=80,
tex_size=1024: 314,988 triangles, 96 alpha-MASK) with the default
RenderConfig (SSR on, MIS GTAO). "The main phase's checks" are: each frame
covers >= 98% of the pixels, drops no bin pair, is finite on every channel
(SSR included), and every kernel of its path launched (per frame at least
K1 x3, the march, K4, K5 x3, K6 and R2; MIN_LAUNCHES_PER_FRAME and the
phase's own table).

1. Needs a CUDA card (exits 1 without one); prints nvidia-smi's name and
   power limit. `python3 chip_smoke.py --multi-card`, on a host of several
   cards, runs only phase 14 over NCCL, one rank per card, 8 band frames
   eager and captured (one graph per rank, its gathers inside).
2. Builds the CUDA kernels (vkr_tpu_torch/csrc, nvcc into
   vkr_tpu_torch/build/) and the native asset pipeline (c++); prints the
   SASS instruction count and loop-body sizes of K1/K7's and the march's
   kernels (cuobjdump -sass). The 1024^2 PDF LUT must have no non-finite
   texel.
3. Main phase: 8 frames with the main phase's checks. Frame 1 renders
   under a PassGraph, whose records must name vkr_tpu's default chain.
3b. Traced phase (traced_phase): the frame through core/aot.py:cached_jit
   (captured into CUDA graphs, the FrameState donated) against the eager
   frame, every output tensor bit for bit, overflow 0 on every replay;
   frame 2's eager body at the captured capacities under
   set_sync_debug_mode("error"); one profiled replay runs each kernel by
   its CUDA symbol (P10 in the probe frame, R1 x8 in the RT frame). On
   this colonnade, bench.py's 16-column colonnade and the Sponza stand-in
   (8 frames), and the SSR-off, probe, RT and glTF trilinear frames (3).
4. SSR-off phase: 3 frames of enable_ssr=False; neither the march nor R2
   may launch.
5. Shadow phase: the 1024^2 shadow map through K7: finite, >= 50%
   covered.
6. Probe phase (BASELINE config 5): build_probe_grid's 96 cubemap faces
   through K1 drop no bin pair; 3 frames of enable_probes=True with the
   main phase's checks and P10 once a frame; probe hits must fill part of
   the pixels SSR left empty in every frame.
7. RT phase: build_scene_tri_grid at vkr_tpu's defaults (48, 24); 3
   frames of gtao.use_ray_query with the main phase's checks, K4 never
   and R1 8 times in every frame, the AO differing from the MIS frame's.
   R1's 8 calls of frame 1 go to the kernel phase.
8. Variants phase: gtao_main_exact, _dense, gtao_normal_space,
   _deinterleaved, gtao_reproject (both modes) and ssao on main frame 1:
   finite, their input's shape. K4's pass gtao_main_window against
   gtao_main_exact within vkr_tpu's bounds (max 1e-3, mean 5e-5) on
   vkr_tpu's close-range corner, and within the mean bound on frame 1.
9. Runtime phase: frame 5 resumed from a checkpoint of frame 4 equals the
   uninterrupted frame bit for bit; save_png decodes to its pixels; the
   depth CSV has a header and a line per row; a cold and a warm build_ssr_resources
   through a disk cache give the main phase's LUTs.
10. Manifest phase: all 41 of vkr_tpu's registered names resolve; the
   passes no frame calls run through registry.get on main frame 1's
   products at 1080p, finite with vkr_tpu's shapes (simple SSR hits > 1%
   of the pixels, the tile lists add up, tile_regression's error +inf on
   at most 0.1% of the tiles, the heatmap counts its window's rays).
11. glTF phase: the colonnade written as .gltf + .bin + 8 PNG (all five
   row filters; 1024^2 REPEAT and 2048x512 CLAMP) and loaded with native
   sizes: its triangles, texture shapes and pairing; 3 trilinear frames
   with the main phase's checks, trilinear moving the albedo of > 1% of
   the pixels; the indexed front end's K1 depth and ids equal to the
   corner path's.
11b. JPEG glTF phase: the same scene with the 8 committed JPEGs of
   tests/torch_images, each decoded to its digest of PIL's
   convert("RGBA"); 3 frames with the main phase's checks, each frame's
   own launches; main frame 0 through cached_jit equal to the direct call.
11c. Sponza phase: bench.py's default workload on the stand-in
   (write_sponza_standin: 25 materials, 69 images) under VKR_ASSETS: every
   JPEG to PIL's digest, 69 textures of 1024^2, at most 12 sampled; 3
   frames with the main phase's checks and each frame's own launches.
11d. P10 phase (p10_phase): probe_orbit's frame at 2560x1440 on the
   stand-in; frame 1's probe_trace call, whole and as the band of rank 1
   of 4, bit for bit against its plain version (image, settling pair and
   code), one launch a call; then with sky rows and NaN normals on a 4x4
   and a 2x2 grid. Prints P10's kernel, plain and bound ms and its
   engagement counter.
12. Bench phase: `python -m vkr_tpu_torch.tools.bench` at its defaults
   with BENCH_BREAKDOWN=1, on sponza_tex (the stand-in), the colonnade in
   flight and serial: exit 0, bench.py's four keys, the stats line, the
   breakdown, every kernel launched in each timed frame; BENCH_FRAMES=1
   exits 1 with bench.py's range error before building a scene.
13. Tools phase: render (through the kernels and --no-kernels), render and
   load_scene of the glTF scene (the native library's mips equal numpy's),
   parity at 64 (within PARITY_MAX_DROP_DB of PARITY_64_CPU_DB) and 256,
   profile (profile_phase: each pass captured bit-equal to the eager pass;
   --scene sponza), scene_info, the viewer over HTTP and the showcase. The
   viewer, showcase and parity run captured and eagerly, and their
   outputs must be equal. The viewer also runs a forced bin overflow (it
   captures anew once and goes on equal to the eager frames) and ten
   toggle combinations (the reserve stays within MAX_CAPTURES captures).
13b. Entry phase: tools/entry.py's frame captured, 3 calls equal to the
   eager fn, pair counts within the capacities, each kernel by symbol in a
   profiled replay; dryrun_multichip(4) prints both of vkr_tpu's OK lines.
14. Multi-device phase: an NCCL probe of 2 ranks on this card (printed,
   not held); 4 gloo ranks on this card render 3 band frames, the
   G-buffer and prev_depth equal to the main phase's bit for bit, colour
   and TAA history within 1e-6; rank 1 holds its band kernel calls and a
   K7 band to their plain versions; each rank's band frame captured
   bit-equal to its eager one (10 segments, 9 host steps) and a forced
   overflow that every rank raises at the same call; 4 views within 1e-6
   of the one-device frames, and captured, bit-equal.
15. Kernel phase: every kernel call of main frame 1 and of the shadow map,
   K1 on the first probe face and R1's 8 calls of RT frame 1, through the
   kernel and its plain version on the card, within compare()'s
   tolerance; prints kernel, plain, library and bound ms (time_ms,
   work_of) and the engagement counts (pairs per tile, patch-reject
   items, march steps and SIMT efficiency). K1/K7 stress tiles of many
   chunks with equal and -0.0 depths; R1 with t_max tensors and its walk
   transcribed (rt_walk); R2 on the 1440p frame, whole and banded, bit for
   bit (r2_phase).
16. The main, probe, RT, glTF, JPEG glTF and Sponza frames again with the
   plain versions substituted: >= 40 dB on every channel of every frame.
17. Prints {"kernels": [...]}, a row a kernel (K1 on the probe faces, P10
   and each band kernel rows of their own), then {"ok": true, "device":
   {...}}.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

from vkr_tpu_torch.tools.entry import _free_port, same_bits

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8
CARD = ""  # nvidia-smi's name and power limit of the cards (cards())
SSR_OFF_FRAMES = 3
PROBE_FRAMES = 3
RT_FRAMES = 3
RT_GRID = dict(resolution=48, cap=24)  # vkr_tpu's build_scene_tri_grid
# the RT frame's AO must differ from the MIS frame's by this much (mean)
MIN_RT_AO_DIFF = 0.01
# vkr_tpu's bound for gtao_main_window against gtao_main_exact
# (tests/test_passes.py::test_window_matches_exact)
WINDOW_EXACT_MAX, WINDOW_EXACT_MEAN = 1e-3, 5e-5
WARMUP_FRAMES = 2
CAPTURE_FRAME = 1
SCENE = dict(columns=24, tessellation=80, tex_size=1024)
# bench.py's other scene (BENCH_SCENE=colonnade)
BENCH_COLONNADE = dict(columns=16, tessellation=64, tex_size=512)
SCENE_TRIANGLES, SCENE_MASKED = 314_988, 96
SHADOW_SIZE = 1024
MIN_COVERAGE = 0.98
MIN_SHADOW_COVERAGE = 0.5
MIN_PSNR_DB = 40.0
FRAME_CHANNELS = ("albedo", "normal", "material", "velocity", "depth", "ssr",
                  "ao", "color")
SLEEP_CYCLES_PER_S = 2e9  # about the H100's SM clock (1.98 GHz boost)
MIN_LAUNCHES_PER_FRAME = {"gbuf_tiles": 3, "hierarchical_march": 1,
                          "window_gather_bilinear_multi": 1,
                          "window_gather_bilinear": 3,
                          "taa_history_gather": 1, "ssr_blur": 1}
# gtao_rt takes the MIS pass's place, so K4 does not launch; it runs R1
# once per chunk of 8 of its 64 directions
RT_MIN_LAUNCHES_PER_FRAME = {"gbuf_tiles": 3, "hierarchical_march": 1,
                             "window_gather_bilinear": 3,
                             "taa_history_gather": 1, "ray_any_hit": 8,
                             "ssr_blur": 1}
# the probe frame (enable_probes with a grid) adds P10's one launch
PROBE_MIN_LAUNCHES_PER_FRAME = dict(MIN_LAUNCHES_PER_FRAME, probe_trace=1)
SSR_OFF_MIN_LAUNCHES_PER_FRAME = {"gbuf_tiles": 3,
                                  "window_gather_bilinear_multi": 1,
                                  "window_gather_bilinear": 2,
                                  "taa_history_gather": 1}
# The H100 SXM's published peaks at 700 W:
# HBM bytes/s and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of one march iteration (csrc/ssr_march.cu): level
# scale 2, fetch position 2, the two xy plane crossings 10, the z crossing
# 2, the minima 2, the new position 6, linearize_depth 4, the horizon
# vector 12, its length 6, the cosine 8, the running max 1
MARCH_FLOPS_PER_ITERATION = 55
PLANE_FLOPS = 4  # fma(a, px, b*py) + c
# float32 operations of one Moller-Trumbore slot test (csrc/ray_any_hit.cu,
# an fma counted as 2; compares and the reject's two scalings not
# counted), by where the test ends (rt_walk's exits): after det, p =
# cross(d, e2) 9 and det 5; before the division, s 3 and a 5 more; after
# u, 1 / det and u; after v, q = cross(s, e1) 9, v 6 and u + v 1; forming
# t, 6 more. The edges are formed once per grid, in the slot records.
MT_OPS = {"det": 14, "a": 22, "u": 24, "v": 40, "t": 46}
# float32 operations of one R2 tap inside its pixel's radius
# (csrc/ssr_blur.cu): the depth weight 6 (difference, abs, the product by
# 1000, the division, 1 - it, the clamp), the normal weight 6 (three
# products, two sums, the clamp), the gaussian 5 (i i + j j, the
# division, expf), the weight 2, the colour 6, the weight sum 1
R2_OPS = 26
R2_RADIUS = 11  # the 23 x 23 window's halo
# R2's phase: the benchmark cells' frame, and the band of rank 1 of 4
R2_WIDTH, R2_HEIGHT = 2560, 1440
R2_BAND_RANK, R2_BAND_RANKS = 1, 4
# float32 operations of csrc/probe_trace.cu (P10), each add, product, division,
# square root, floor, min, max and compare one, by where they fall: a walked
# pixel (the normal's decode 26, the world position and the reflected ray 40,
# the probe spacing 6, the three inverse directions 6, its grid cell 18, the
# sky test 1); each neighbour it visits (the origin 9, the three plane
# crossings 6, their sort 6 and clamp 6, four skip tests 12); each pair it
# marches, beyond the steps (the ends and the degenerate test 23, two
# octahedral encodings 60, oct_center 28, the two planar depths 21, the march's
# start 32, the stop and the depth test 20); each march step (the level scale
# 1, the fetch position 2 and its casts 4, the xy plane crossings 12, the z
# crossing 3, the minima and clamp 3, the two tests 2, the new t 2 and position
# 6); each hit's bilinear colour
P10_OPS = {"pixel": 97, "neighbour": 39, "pair": 186, "step": 35, "hit": 41}
# P10's phase: probe_orbit's frame (BASELINE config 5 at 2560x1440), and
# the band of rank 1 of 4
P10_WIDTH, P10_HEIGHT = 2560, 1440
P10_BAND_RANK, P10_BAND_RANKS = 1, 4
# rows of that frame's half-res inputs made sky (depth 1) and given NaN
# normals, for the paths its own data hardly takes
P10_SKY_ROWS, P10_NAN_ROWS = slice(0, 16), slice(16, 32)
# PR 15's count, every test charged in full with its edges (6): printed
# beside the bound, to set this run against PR 15's figures
MT_FLOPS_PR15 = 52
# K1/K7 stress calls on one tile: (tile width, pairs, K1 with a peel floor).
# 8x128: one cell, 160 chunks; 8x512: four cells of 16 chunks each.
STRESS = ((128, 20_480, False), (512, 2_048, True))

# name -> (source, the TPU kernel(s) it replaces)
KERNELS = {
    "gbuf_tiles": ("vkr_tpu_torch/csrc/gbuf_tiles.cu",
                   "vkr_tpu/raster/gbuf_kernel.py:41"),
    "hierarchical_march": ("vkr_tpu_torch/csrc/ssr_march.cu",
                           "vkr_tpu/passes/ssr_march.py:149 and :368"),
    "window_gather_bilinear_multi": ("vkr_tpu_torch/csrc/window_gather.cu",
                                     "vkr_tpu/raster/gather_kernel.py:192"),
    "window_gather_bilinear": ("vkr_tpu_torch/csrc/window_gather.cu",
                               "vkr_tpu/raster/gather_kernel.py:56"),
    "taa_history_gather": ("vkr_tpu_torch/csrc/window_gather.cu",
                           "vkr_tpu/raster/gather_kernel.py:333"),
    "rasterize_tiles": ("vkr_tpu_torch/csrc/gbuf_tiles.cu",
                        "vkr_tpu/raster/kernel.py:67"),
    # R1: vkr_tpu computes ray_any_hit in jnp (no pallas_call)
    "ray_any_hit": ("vkr_tpu_torch/csrc/ray_any_hit.cu",
                    "vkr_tpu/scene/accel.py:140"),
    # R2: vkr_tpu computes the SSR blur's taps in jnp (no pallas_call)
    "ssr_blur": ("vkr_tpu_torch/csrc/ssr_blur.cu",
                 "vkr_tpu/passes/ssr.py:858"),
    # P10: vkr_tpu computes the probe trace in jnp (no pallas_call)
    "probe_trace": ("vkr_tpu_torch/csrc/probe_trace.cu",
                    "vkr_tpu/passes/probes.py:382"),
}
# K1 on the probe grid's cubemap faces at start-up: a row of its own
PROBE_FACE_ROW = "gbuf_tiles (probe faces)"
KERNELS[PROBE_FACE_ROW] = KERNELS["gbuf_tiles"]

# vkr_tpu's default frame chain (frame.py's add_task names, in order)
MAIN_CHAIN = ["GbufferPass", "DownsampleGbuffer", "SSSR_trace",
              "SSSR_filter", "SSSR_blur", "GTAO_main", "GTAO_filter",
              "GTAO_accumulate", "DeferedShading", "TAA"]
# the runtime phase checkpoints the FrameState after this frame and
# resumes the next from it
CHECKPOINT_FRAME = 4
# vkr_tpu.core.registry.names() after importing vkr_tpu.frame and every
# pass and raster module (tests/test_torch_registry.py holds this list
# against vkr_tpu's; this script cannot import vkr_tpu)
MANIFEST_NAMES = [
    "brdf_preintegrate", "cube2oct", "cubemap_probe", "default_shadow",
    "defered_shading", "deinterleave_depth", "depth_mips",
    "downsample_depth", "downsample_gbuffer", "downsample_hiz",
    "gbuf_opaque", "gbuf_opaque_taa", "gtao_accumulate",
    "gtao_compute_main", "gtao_filter", "gtao_main", "gtao_main_dense",
    "gtao_main_mis", "gtao_normal_space", "gtao_reproject", "gtao_rt",
    "gtao_rt_main", "main_deinterleaved", "pdf_preintegrate", "perlin",
    "probe_downsample", "rotations", "screen_trace_accumulate",
    "screen_trace_filter", "screen_trace_main", "ssao", "ssr",
    "sssr_blur", "sssr_classification", "sssr_filter", "sssr_trace",
    "sssr_trace_indirect", "taa_resolve", "texdraw", "tile_regression",
    "trace_probe"]
# simple SSR reflects every pixel as a mirror: the hall's floor and walls
# must give hits in more than this share of the pixels
MIN_SIMPLE_SSR_HITS = 0.01
# tile_regression: the share of tiles whose error may overflow to +inf
MAX_REGRESSION_OVERFLOW = 0.001


# tools phase: parity.main --scene colonnade --size 64 on the CPU
# (tests/test_torch_tools.py pins these figures, in dB); the card's figures
# may fall at most PARITY_MAX_DROP_DB below them, unless both are at least
# PARITY_HIGH_DB
PARITY_64_CPU_DB = {"albedo": 37.37, "normal": 35.7, "depth": 66.85,
                    "velocity": 117.6, "material": 78.72, "ao": 37.5,
                    "ssr": 53.59, "color": 56.37}
PARITY_MAX_DROP_DB = 1.0
PARITY_HIGH_DB = 50.0


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def plain_versions():
    """kernel wrapper name -> (module, its plain PyTorch version)."""
    from vkr_tpu_torch.passes import probes, ssr_blur_kernel, ssr_march
    from vkr_tpu_torch.raster import gather_kernel, gbuf_kernel, kernel
    from vkr_tpu_torch.scene import accel

    return {
        "gbuf_tiles": (gbuf_kernel, gbuf_kernel.gbuf_tiles_reference),
        "hierarchical_march": (ssr_march,
                               ssr_march.hierarchical_march_reference),
        "window_gather_bilinear_multi": (
            gather_kernel, gather_kernel.window_gather_multi_reference),
        "window_gather_bilinear": (gather_kernel,
                                   gather_kernel.window_gather_reference),
        "taa_history_gather": (gather_kernel,
                               gather_kernel.taa_history_gather_reference),
        "rasterize_tiles": (kernel, kernel.rasterize_tiles_reference),
        "ray_any_hit": (accel, accel.ray_any_hit_reference),
        "ssr_blur": (ssr_blur_kernel, ssr_blur_kernel.ssr_blur_reference),
        "probe_trace": (probes, probes.probe_trace_reference),
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


def recording(log, limit=None, only=None):
    """Substitute factory: call the kernel, keeping a copy of its inputs
    (of the first `limit` calls only, where a limit is given; of the
    wrappers named in `only`, where it is given)."""
    import torch

    def make(name, wrapper, plain):
        def rec(*args, **kw):
            if ((limit is None or len(log) < limit)
                    and (only is None or name in only)):
                kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)
                log.append((name, kept, dict(kw)))
            return wrapper(*args, **kw)
        return rec
    return make


def render(scene, res, cfg, device, n_frames, on_frame=None,
           probe_grid=None, tri_grid=None):
    """The bench loop (bench.py): frame i sees orbit view i after view i-1.
    Returns per-frame outputs. With a probe grid, an output also holds the
    share of the pixels SSR left empty that a probe hit filled."""
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    state = FrameState.initial(cfg.height, cfg.width, device)
    outs = []
    for i in range(n_frames):
        cam = camera_frame(cfg, bench_orbit_view(i),
                           bench_orbit_view(max(i - 1, 0)), i, device)
        with (on_frame(i) if on_frame is not None
              else contextlib.nullcontext()):
            color, state, aux = render_frame(scene, state, cam, res, cfg,
                                             probe_grid=probe_grid,
                                             tri_grid=tri_grid)
        g = aux["gbuffer"]
        out = {k: getattr(g, k) for k in FRAME_CHANNELS[:5]}
        out.update(ssr=aux["ssr"], ao=aux["ao"], color=color,
                   overflow=int(aux["overflow"]), ssr_rays=aux["ssr_rays"])
        if aux["probe"] is not None:
            empty = aux["ssr_rays"][..., 3] >= 1.0
            out["probe_filled"] = float(
                (empty & (aux["probe"][..., 3] > 0.0)).sum() / empty.sum())
        outs.append(out)
    return outs


def check_frames(outs, launches, n_frames, min_per_frame, label):
    import torch

    for i, o in enumerate(outs):
        cov = float((o["depth"] < 1.0).float().mean())
        check(cov >= MIN_COVERAGE, f"{label} frame {i}: coverage {cov:.4f}")
        check(o["overflow"] == 0, f"{label} frame {i}: {o['overflow']} bin "
              "pairs dropped")
        for k in FRAME_CHANNELS:
            check(bool(torch.isfinite(o[k]).all()), f"{label} frame {i}: "
                  f"{k} is not finite")
        check(tuple(o["color"].shape) == (HEIGHT, WIDTH, 3),
              f"{label} frame {i}: colour shape {tuple(o['color'].shape)}")
    for name, per_frame in min_per_frame.items():
        check(launches.get(name, 0) >= per_frame * n_frames,
              f"{label}: {name} launched {launches.get(name, 0)} times in "
              f"{n_frames} frames")


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


def compare(name, got, want, args, kw=None):
    """(max abs error, within tolerance, note) of a kernel's outputs against
    its plain version's (args, kw: the call's).

    K1: depth and triangle id equal (the same fma-form plane evaluation
    and the same d <= z walk), attributes within 1e-6 + 1e-6 |x| (a
    float64-emulated fma may round differently from fmaf on a float32
    tie). K7: depth and triangle id equal. R2: bit-equal (the taps in
    the same order, the same roundings). K4/K5/K6: the same
    clamp/floor/lerp sequence in float32 without contraction, atol 1e-6.
    The march: the same operations in the same order, so bit-equal
    rays are expected; required are validity agreement >= 0.9999 and
    |position| and |hor| within 1e-5 over rays valid in both. R1: equal
    hits, or every ray that differs a double-rounding case (rt_compare)."""
    import torch

    if name == "gbuf_tiles":
        (z, tid, attrs), (z0, tid0, attrs0) = got, want
        err = max(float((z - z0).abs().max()),
                  float((attrs - attrs0).abs().max()))
        ok = (torch.equal(z, z0) and torch.equal(tid, tid0)
              and bool(((attrs - attrs0).abs()
                        <= 1e-6 + 1e-6 * attrs0.abs()).all()))
        return err, ok, ""
    if name == "rasterize_tiles":
        (z, tid), (z0, tid0) = got, want
        return (float((z - z0).abs().max()),
                torch.equal(z, z0) and torch.equal(tid, tid0), "")
    if name == "ray_any_hit":
        return rt_compare(got, want, args, kw or {})
    if name == "ssr_blur":
        return float((got - want).abs().max()), same_bits(got, want), ""
    if name == "hierarchical_march":
        (pos, hor, it), (pos0, hor0, it0) = got, want[:3]
        max_it = args[6]
        valid, valid0 = it <= max_it, it0 <= max_it
        both = valid & valid0
        agree = float((valid == valid0).float().mean())
        err = max(float((pos - pos0).abs().amax(-1)[both].max()),
                  float((hor - hor0).abs()[both].max()))
        bit_equal = float((torch.eq(pos, pos0).all(-1) & torch.eq(hor, hor0)
                           & torch.eq(it, it0)).float().mean())
        return (err, agree >= 0.9999 and err <= 1e-5,
                f"validity agreement {agree:.6f}, bit-equal rays "
                f"{bit_equal:.6f}")
    err = float((got - want).abs().max())
    return err, err <= 1e-6, ""


def shape_of(name, args, kw):
    band = (f", rows from {kw['row_offset']}" if kw.get("row_offset")
            else f", rows from {kw['row0']}" if kw.get("row0") else "")
    if name == "gbuf_tiles":
        return (f"{kw['width']}x{kw['height']}, "
                f"{kw['tile_h']}x{kw['tile_w']} tiles, "
                f"{int(args[2].sum())} pairs"
                + (", peel" if args[3] is not None else "") + band)
    if name == "rasterize_tiles":
        return (f"{kw['width']}x{kw['height']}, {int(args[2].sum())} pairs"
                + band)
    if name == "ray_any_hit":
        return (f"{tuple(args[1].shape[:-1])} rays, max_steps "
                f"{kw.get('max_steps')}, grid {args[0].dims} cap "
                f"{args[0].cap}")
    if name == "hierarchical_march":
        return (f"{tuple(args[1].shape[:-1])} rays, "
                f"{len(args[0].offsets)} levels, max {args[6]} iterations")
    return " ".join(str(tuple(a.shape)) for a in args
                    if hasattr(a, "shape")) + band


def walk_pairs(rows, starts, counts):
    """(tile, pair row) of every pair of the walk, in segment order."""
    import torch

    dev = rows.device
    cnt = counts.long()
    tile = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    order = torch.arange(tile.numel(), device=dev)
    return tile, rows.reshape(-1, 64)[starts.long()[tile] + order
                                      - first[tile]]


def covered_pair_pixels(rows, starts, counts, kw, chunk_evals=1 << 24):
    """Pair-pixels of the walk that their pair covers under plane() (all
    three edges >= 0): the tests any walk must make, whatever it skips. It
    depends on the inputs alone, not on how a kernel walks them."""
    import torch

    from vkr_tpu_torch.raster.gbuf_kernel import plane

    tile_h, tile_w = kw["tile_h"], kw["tile_w"]
    tiles_x = -(-kw["width"] // tile_w)
    tile, r = walk_pairs(rows, starts, counts)
    dev = rows.device
    ly = torch.arange(tile_h, device=dev).repeat_interleave(tile_w)
    lx = torch.arange(tile_w, device=dev).repeat(tile_h)
    step = max(1, chunk_evals // (tile_h * tile_w))
    total = 0
    for lo in range(0, tile.numel(), step):
        t = tile[lo:lo + step, None]
        px = ((t % tiles_x) * tile_w + lx).float() + 0.5
        py = ((t // tiles_x) * tile_h + ly
              + kw.get("row_offset", 0)).float() + 0.5
        q = r[lo:lo + step]
        cover = torch.ones(px.shape, dtype=torch.bool, device=dev)
        for i in range(3):
            cover &= plane(q[:, i, None], q[:, 3 + i, None],
                           q[:, 6 + i, None], px, py) >= 0.0
        total += int(cover.sum())
    return total


def patch_survivors(rows, starts, counts, kw):
    """(pair, 8x16 patch) items that csrc/gbuf_tiles.cu's warp-uniform
    reject keeps, and all of them: its edge_rejects transcribed in float32
    (the plane at the patch corner that maximises it, against the margin
    ((|a| x1 + |b| y1) + |c|) 2^-20 + 2^-100). The walk tests the 128
    pixels of each kept item."""
    import torch

    from vkr_tpu_torch.raster.gbuf_kernel import plane

    tile_h, tile_w = kw["tile_h"], kw["tile_w"]
    tiles_x = -(-kw["width"] // tile_w)
    tile, r = walk_pairs(rows, starts, counts)
    dev = rows.device
    py0 = torch.arange(0, tile_h, 8, device=dev)[:, None]
    px0 = torch.arange(0, tile_w, 16, device=dev)[None, :]
    x0 = ((tile % tiles_x) * tile_w)[:, None, None] + px0 + 0.5
    y0 = ((tile // tiles_x) * tile_h + kw.get("row_offset", 0))[
        :, None, None] + py0 + 0.5
    x0, y0 = x0.float(), y0.float()
    x1, y1 = x0 + 15.0, y0 + 7.0
    rejected = torch.zeros(x0.shape, dtype=torch.bool, device=dev)
    for i in range(3):
        a, b, c = (r[:, k, None, None] for k in (i, 3 + i, 6 + i))
        e = plane(a, b, c, torch.where(a > 0, x1, x0),
                  torch.where(b > 0, y1, y0))
        m = ((a.abs() * x1 + b.abs() * y1) + c.abs()) * 2.0 ** -20 \
            + 2.0 ** -100
        rejected |= e < -m
    return int((~rejected).sum()), rejected.numel()


def winning_rows(tid, kw):
    """Distinct pair rows that win a pixel of the plain version's output: a
    segment holds one row per (tile, clipped triangle), so the distinct
    (tile, triangle id) of the covered pixels."""
    import torch

    hp, wp = tid.shape
    dev = tid.device
    tiles_x = wp // kw["tile_w"]
    gy = torch.arange(hp, device=dev)[:, None] // kw["tile_h"]
    gx = torch.arange(wp, device=dev)[None, :] // kw["tile_w"]
    key = (gy * tiles_x + gx) * (int(tid.max()) + 1) + tid.long()
    return int(torch.unique(key[tid >= 0]).numel())


def quantiles(t):
    t = t.double().flatten()
    return (f"min {float(t.min()):.0f}, median {float(t.median()):.0f}, p99 "
            f"{float(t.quantile(0.99)):.1f}, max {float(t.max()):.0f}, mean "
            f"{float(t.mean()):.1f}")


def work_of(name, args, kw, plain):
    """(bytes, float32 operations) the call needs on this run's inputs:
    each input read once, each output written once; data-dependent work
    as this run's data needs it."""
    import torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    if name in ("gbuf_tiles", "rasterize_tiles"):
        rows, starts, counts = args[:3]
        # the pixels the caller keeps: a 128-wide probe face is one quarter
        # of an 8x512 tile
        px = kw["width"] * kw["height"]
        n_pairs = int(counts.sum())
        # 4 planes per pair-pixel a walk must test: those its pair covers
        pair_px = covered_pair_pixels(rows, starts, counts, kw)
        # every pair's 12 raster floats; the winners' fields once each
        wins = winning_rows(plain[1], kw)
        if name == "gbuf_tiles":
            peel = args[3] if len(args) > 3 else None
            out_bytes = px * 4 * (2 + 10)
            # the id and the resolve fields (denominator, 9 channel planes,
            # material): 32 floats
            in_bytes = n_pairs * 12 * 4 + wins * 32 * 4 + nbytes(peel)
            # then 10 resolve planes per pixel
            ops = (pair_px * 4 + px * 10) * PLANE_FLOPS
        else:
            out_bytes = px * 4 * 2
            in_bytes = n_pairs * 12 * 4 + wins * 4  # and the winners' ids
            ops = pair_px * 4 * PLANE_FLOPS
        return in_bytes + nbytes(starts, counts) + out_bytes, ops
    if name == "ray_any_hit":
        grid, origin, direction, t_max = args[:4]
        n_rays = origin.numel() // 3
        steps = kw.get("max_steps")
        _, tests, exits = rt_walk(*args[:4], steps)
        check(int(tests.sum()) == rt_slot_tests(*args[:4], steps),
              "R1: rt_walk's slot tests differ from rt_slot_tests'")
        # each ray's origin, direction (and t_max tensor) once, its hit;
        # the filled slot records (48 bytes each) and the spans once; each
        # test's operations up to where it ends
        return (n_rays * (2 * 3 * 4 + 1) + int(grid.spans[:, 1].sum()) * 48
                + nbytes(t_max, grid.spans, grid.grid_min, grid.cell_size),
                sum(MT_OPS[k] * n for k, n in exits.items()))
    if name == "ssr_blur":
        refl, depth, normal, sigma = args[:4]
        big_h, w = depth.shape
        row0, h = kw.get("row0", 0), sigma.shape[0]
        # the band's rows and their halo of the whole frame's planes,
        # sigma and the colour once; R2_OPS for each tap inside its
        # pixel's radius on this frame's sigma plane
        rows = (min(big_h, row0 + h + R2_RADIUS)
                - max(0, row0 - R2_RADIUS))
        return (rows * w * (3 + 1 + 3) * 4 + nbytes(sigma) + h * w * 3 * 4,
                r2_taps(sigma) * R2_OPS)
    if name == "probe_trace":
        # P10's inputs (view_positions' depth, normals and rotated view
        # vectors) and the grid's colours and pyramids once, the image
        # once; P10_OPS for the pairs and steps this run's data marches up
        # to each pixel's settling pair (plain: the plain march's image
        # and settle output)
        grid = args[2]
        work = p10_work(p10_rays(args, kw), grid, plain[1])
        return (nbytes(*p10_inputs(args, kw)[:3], grid.colors,
                       grid.depth_flat, plain[0]),
                sum(P10_OPS[k] * work[k] for k in P10_OPS))
    if name == "hierarchical_march":
        pyr, rays = args[0], args[1:5]
        steps = plain[3]
        n_rays = rays[0].numel() // 3
        return (nbytes(pyr.flat, *rays) + n_rays * 5 * 4,
                int(steps.sum()) * MARCH_FLOPS_PER_ITERATION)
    # window gathers: about 10 float32 operations per bilinear tap; a band
    # call's taps reach only its rows and a radius-wide halo of the images
    out = plain
    taps = out.numel() // (out.shape[-1] if name == "window_gather_bilinear"
                           and out.ndim == 3 else 1)
    n_img = 2 if name == "taa_history_gather" else 1
    bh = args[n_img].shape[-2]
    radius = kw.get("radius", 16)
    images = sum(nbytes(a) * min(1.0, (bh + 2 * radius + 1) / a.shape[0])
                 for a in args[:n_img])
    return int(images) + nbytes(*args[n_img:]) + nbytes(out), taps * 10


def r2_radius(sigma):
    """R2's tap radius per pixel, -1 (no tap) to 11: floor(3 sigma -
    0.01) as the kernel and its plain version compute it."""
    import torch

    return torch.floor(3.0 * sigma - 0.01).clamp(-1, R2_RADIUS)


def r2_taps(sigma) -> int:
    """Taps inside each pixel's radius, summed: the taps R2 computes on
    finite inputs."""
    r = r2_radius(sigma).double()
    return int(((2 * r + 1) ** 2 * (r >= 0)).sum())


def simt_efficiency(steps, patch_w, patch_h):
    """Sum of steps / sum of (32 x the warp's longest) for warps of
    patch_w x patch_h = 32 rays of the (h, w) ray grid, one ray per lane
    and no refill."""
    h, w = steps.shape
    s = steps[:h // patch_h * patch_h, :w // patch_w * patch_w].double()
    peak = s.reshape(h // patch_h, patch_h, w // patch_w, patch_w).amax(
        dim=(1, 3))
    return float(s.sum() / (peak.sum() * patch_w * patch_h))


def fma_exact(a, b, c):
    """a * b + c of float32 tensors rounded once to float32, as fmaf and
    XLA's fma round it. The product is exact in float64; the sum is
    rounded to odd there (the exact sum's error from TwoSum decides), and
    a sum rounded to odd in 53 bits rounds to float32 as the exact sum
    does. mathlib/brdf.py:_fma rounds the float64 sum to nearest instead,
    and so rounds twice."""
    import torch

    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact = torch.isfinite(s) & torch.isfinite(err) & (err != 0.0)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0.0, math.inf, -math.inf).to(s)
    return torch.where(inexact & even, torch.nextafter(s, toward),
                       s).float()


def rt_slot_tests(grid, origin, direction, t_max, max_steps):
    """Moller-Trumbore tests the walk needs on these rays: in each cell it
    visits, the slots that hold a triangle, up to the first that hits (as
    csrc/ray_any_hit.cu tests them). Counted on the plain version's walk,
    its empty slots pointed at a NaN triangle, which no ray hits."""
    import torch

    from vkr_tpu_torch.scene import accel

    n_tri = grid.tri_verts.shape[0]
    nan_tri = torch.full((1, 3, 3), math.nan, device=grid.tri_verts.device)
    marked = dataclasses.replace(
        grid, tri_verts=torch.cat([grid.tri_verts, nan_tri]),
        cell_tris=torch.where(grid.cell_tris < 0, n_tri, grid.cell_tris))
    count = []
    slot_mask = accel._tri_hit_mask

    def counting(orig, dirs, v0, e1, e2, tm, eps=1e-12):
        m = slot_mask(orig, dirs, v0, e1, e2, tm, eps)
        cap = m.shape[-1]
        first = torch.where(m.any(-1), m.int().argmax(-1) + 1, cap)
        upto = torch.arange(cap, device=m.device) < first[:, None]
        count.append((upto & ~torch.isnan(v0[..., 0])).sum())
        return m
    accel._tri_hit_mask = counting
    try:
        accel.ray_any_hit_reference(marked, origin, direction, t_max,
                                    max_steps=max_steps)
    finally:
        accel._tri_hit_mask = slot_mask
    return int(sum(count))


def rt_compare(got, want, args, kw):
    """R1 against its plain version: (max abs error of the hits, ok, note).
    Every ray whose hit differs is reported by count and index, and is
    walked again by the plain version with fma_exact in place of _fma:
    each must then give the kernel's hit, and so be a case where _fma's
    float64 sum fell on a float32 tie (fmaf rounds once)."""
    import torch

    from vkr_tpu_torch.scene import accel

    grid, origin, direction, t_max = args[:4]
    diff = torch.nonzero((got != want).reshape(-1)).flatten()
    n = int(diff.numel())
    if n == 0:
        return 0.0, True, f"hits equal on all {got.numel()} rays"
    rays = [t.reshape(-1, 3)[diff] for t in (origin, direction)]
    if isinstance(t_max, torch.Tensor) and t_max.dim():
        t_max = t_max.expand(origin.shape[:-1]).reshape(-1)[diff]
    walks = {}
    saved = accel._fma
    for label, fma in (("_fma", saved), ("fma_exact", fma_exact)):
        accel._fma = fma
        try:
            walks[label] = accel.ray_any_hit_reference(grid, *rays, t_max,
                                                       **kw)
        finally:
            accel._fma = saved
    kernel_hits = got.reshape(-1)[diff]
    ties = bool(torch.equal(walks["fma_exact"], kernel_hits)
                and torch.equal(walks["_fma"], want.reshape(-1)[diff]))
    shown = diff.tolist()
    return (1.0, ties,
            f"{n} of {got.numel()} rays differ, indices "
            f"{shown[:64]}{' ...' if n > 64 else ''}; the plain walk with "
            f"fma_exact gives the kernel's hit on "
            f"{int((walks['fma_exact'] == kernel_hits).sum())} of them"
            + (" (double-rounding cases of _fma)" if ties else ""))


def rt_walk(grid, origin, direction, t_max, max_steps=None):
    """csrc/ray_any_hit.cu's walk transcribed to PyTorch: each ray's DDA
    over the grid's slot records (grid.records, grid.spans: a cell's filled
    slots in record order, up to the first that hits), each slot test
    leaving where the kernel leaves it: a miss after det, before the
    division (a_rejects, a = dot3(s, p)), after u, after v. Rays leave the
    work where the kernel's thread returns. Returns (hits of the leading
    shape, slot tests per ray (int32, flat), tests that left {"det", "a",
    "u", "v"} and that formed t {"t"}, as ints)."""
    import torch

    from vkr_tpu_torch.scene.accel import cross, dot3

    lead = origin.shape[:-1]
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)
    dev = o.device
    n = o.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    tm = tm.expand(lead).reshape(-1)
    sx, sy, sz = grid.dims
    dims = torch.tensor([sx, sy, sz], device=dev)
    steps = sum(grid.dims) if max_steps is None else int(max_steps)
    small = d.abs() < 1e-20
    inv_d = torch.where(small, 1e20, 1.0 / torch.where(d == 0.0, 1.0, d))
    rel = (o - grid.grid_min) / grid.cell_size
    ic = torch.minimum(torch.floor(rel).clamp(-1.0, 2.0 ** 24).long()
                       .clamp(min=0), dims - 1)
    step = torch.where(d >= 0.0, 1, -1)
    t_next = ((ic + (step > 0).long()).float() * grid.cell_size
              + grid.grid_min - o) * inv_d
    t_next = torch.where(small, 1e20, t_next)
    dt = (grid.cell_size * inv_d).abs()

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    tests = torch.zeros(n, dtype=torch.int32, device=dev)
    left = {"det": 0, "a": 0, "u": 0, "v": 0, "t": 0}
    ids = torch.arange(n, device=dev)
    for _ in range(steps):
        if ids.numel() == 0:
            break
        oo, dd, tt = o[ids], d[ids], tm[ids]
        flat = ((ic[:, 2] * sy + ic[:, 1]) * sx + ic[:, 0]).clamp(
            0, sx * sy * sz - 1)
        start, count = grid.spans[flat].long().unbind(-1)
        walking = torch.ones_like(ids, dtype=torch.bool)
        for j in range(int(count.max()) if count.numel() else 0):
            act = walking & (j < count)
            rec = grid.records[(start + j).clamp(max=grid.records.shape[0]
                                                 - 1)]
            v0, e1, e2 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
            p = cross(dd, e2)
            det = dot3(e1, p)
            ok_det = det.abs() >= 1e-20
            s = oo - v0
            a = dot3(s, p)
            ok_a = ok_det & ~a_rejects(a, det)
            inv = 1.0 / torch.where(ok_det, det, 1.0)
            u = a * inv
            ok_u = ok_a & (u >= 0.0) & ~(u > 1.0)
            q = cross(s, e1)
            v = dot3(dd, q) * inv
            ok_v = ok_u & (v >= 0.0) & (u + v <= 1.0)
            t = dot3(e2, q) * inv
            h = act & ok_v & (t > 1e-12) & (t < tt)
            tests[ids] += act.int()
            for key, passed, before in (("det", ok_det, act),
                                        ("a", ok_a, act & ok_det),
                                        ("u", ok_u, act & ok_a),
                                        ("v", ok_v, act & ok_u)):
                left[key] += int((before & ~passed).sum())
            left["t"] += int((act & ok_v).sum())
            hit[ids[h]] = True
            walking &= ~h
        # the DDA step; a NaN t_next (amin NaN) ends the walk after its
        # cell
        tmin = t_next.amin(-1)
        onehot = torch.argmin(t_next, -1)[:, None] == torch.arange(3,
                                                                   device=dev)
        ic = ic + torch.where(onehot, step[ids], 0)
        t_next = t_next + torch.where(onehot, dt[ids], 0.0)
        inside = ((ic >= 0) & (ic < dims)).all(-1)
        keep = torch.nonzero(walking & inside & (tmin <= tt)).squeeze(1)
        ids, ic, t_next = ids[keep], ic[keep], t_next[keep]
    return hit.reshape(lead), tests, left


def a_rejects(a, det):
    """csrc/ray_any_hit.cu's test before the division, in float32: True
    where u = a * (1 / det) lies out of [0, 1] for certain, |a| > |det|
    (1 + 2^-20) (|u| > 1 through both roundings), or a and det of opposite
    signs with |a| > |det| 2^-50 (u < 0, too far from 0 to round to -0.0).
    NaN a: False."""
    import torch

    aa, ad = a.abs(), det.abs()
    opposite = torch.signbit(a) != torch.signbit(det)
    return (aa > ad * (1.0 + 2.0 ** -20)) | (opposite & (aa > ad * 2.0 ** -50))


def rt_lane_rays(pixels, dirs, warp=32):
    """A thread -> ray map that csrc/ray_any_hit.cu measured and left
    (it takes rays in order, thread i on ray i): for rays (pixels, dirs),
    ray p * dirs + c, warp w takes direction w % dirs of the 32 pixels from
    (w // dirs) * 32; -1 for the threads past the last pixel."""
    import torch

    threads = -(-pixels // warp) * warp * dirs
    k = torch.arange(threads)
    w = k // warp
    p = w // dirs * warp + k % warp
    return torch.where(p < pixels, p * dirs + w % dirs, -1)


def tile_lane_rays(h, w, dirs, tile_w, tile_h, stride=1):
    """A candidate thread -> ray map for rays (h, w, dirs): a warp takes one
    direction of tile_w x tile_h pixels spaced `stride` apart (stride 4:
    pixels of one class of gtao_rt's 4x4 dither pattern); -1 for threads
    whose pixel lies outside."""
    import torch

    assert tile_w * tile_h == 32
    span_w, span_h = tile_w * stride, tile_h * stride
    tx, ty = -(-w // span_w), -(-h // span_h)
    lane = torch.arange(32)
    # warps: (tile row, tile column, class y, class x, direction)
    idx = torch.arange(ty * tx * stride * stride * dirs)
    c = idx % dirs
    k = idx // dirs
    cx, cy = k % stride, k // stride % stride
    col, row = k // (stride * stride) % tx, k // (stride * stride * tx)
    x = (col * span_w + cx)[:, None] + lane % tile_w * stride
    y = (row * span_h + cy)[:, None] + lane // tile_w * stride
    ray = (y * w + x) * dirs + c[:, None]
    return torch.where((x < w) & (y < h), ray, -1).reshape(-1)


def lane_efficiency(work, thread_items, warp=32):
    """Sum of work / sum of (32 x the warp's largest) for warps of 32
    consecutive threads, thread k taking item thread_items[k] (-1: no
    item): the share of lane-steps that do work, with no refill."""
    import torch

    rays = thread_items.to(work.device)
    w = torch.where(rays >= 0, work[rays.clamp(min=0)], 0).double()
    w = w.reshape(-1, warp)
    return float(w.sum() / (w.amax(1).sum() * warp))


def sass_text(path):
    from vkr_tpu_torch import kernels

    cuobjdump = kernels.nvcc_path()[:-len("nvcc")] + "cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def slot_test_loop(path):
    """(instructions, divisions, instructions per slot test) of the slot
    loop of a built R1 library (cuobjdump -sass): the shortest loop body
    (instructions a backward branch spans) that holds a reciprocal
    (MUFU.RCP, the 1 / det of each test), divided by the reciprocals in
    it, so an unrolled loop counts per test. A static count: the early
    exits skip the rest of a test's body."""
    text = sass_text(path)
    block = [b for b in text.split("Function : ")[1:]
             if "ray_any_hit_kernel" in b.split("\n", 1)[0]][0]
    insns = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
    best = None
    for addr, ins in insns:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in insns if int(m.group(1), 16) <= a <= addr
                and not re.search(r"\bNOP\b", i)]
        rcp = sum(1 for i in body if "MUFU.RCP" in i)
        if rcp and (best is None or len(body) < best[0]):
            best = (len(body), rcp)
    check(best is not None, f"{path}: no loop with a MUFU.RCP")
    return best[0], best[1], best[0] / best[1]


def res_usage(path, kernel="ray_any_hit_kernel"):
    """cuobjdump -res-usage's line for `kernel` in a built library:
    {"REG": registers a thread, "STACK": ..., "LOCAL": spill bytes, ...}."""
    from vkr_tpu_torch import kernels

    cuobjdump = kernels.nvcc_path()[:-len("nvcc")] + "cuobjdump"
    text = subprocess.run([cuobjdump, "-res-usage", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Function" in line and kernel in line:
            return {k: int(v) for k, v in re.findall(r"(\w+):(\d+)",
                                                     lines[i + 1])}
    raise SmokeFailure(f"cuobjdump -res-usage: no {kernel} in {path}")


R1_TMAX_SEED = 16
ISSUE_PER_CLOCK = 132 * 4 * 32  # SMs x warp instructions x lanes a clock


def r2_phase(scene, res, device):
    """R2 on the benchmark cells' frame: frames 0 and 1 of the bench orbit
    at R2_WIDTH x R2_HEIGHT in this colonnade (eager, every kernel), frame
    1's blur call recorded. R2 against its plain version bit for bit on
    the whole frame and on the band of rank R2_BAND_RANK of R2_BAND_RANKS
    (whose rows must also equal the whole call's), each with kernel,
    plain and bound ms; the radius histogram and the taps it needs;
    registers and spills. Returns the two cases."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=R2_WIDTH, height=R2_HEIGHT)
    calls = []

    def hook(i):
        if i == CAPTURE_FRAME:
            return Substitute(recording(calls, only=("ssr_blur",)))
        return contextlib.nullcontext()
    render(scene, res, cfg, device, CAPTURE_FRAME + 1, on_frame=hook)
    check(len(calls) == 1, f"r2: {len(calls)} ssr_blur calls recorded in "
          f"{R2_WIDTH}x{R2_HEIGHT} frame {CAPTURE_FRAME}")
    _, args, kw = calls[0]
    refl, depth, normal, sigma = args
    bh = depth.shape[0] // R2_BAND_RANKS
    r0 = R2_BAND_RANK * bh
    band = ((refl, depth, normal, sigma[r0:r0 + bh].contiguous()),
            dict(kw, row0=r0))
    plain = plain_versions()
    wrappers = {k: getattr(mod, k) for k, (mod, _) in plain.items()}
    whole = wrappers["ssr_blur"](*args, **kw)
    cases = []
    for label, (a, k) in (("whole frame", (args, kw)),
                          (f"band of rank {R2_BAND_RANK} of "
                           f"{R2_BAND_RANKS}", band)):
        case, ok, _, _ = measure_call("ssr_blur", a, k, wrappers, plain)
        note = ""
        if k.get("row0"):
            rows_equal = same_bits(wrappers["ssr_blur"](*a, **k),
                                   whole[r0:r0 + bh])
            note = (f", rows {'equal' if rows_equal else 'DIFFER FROM'} "
                    "the whole call's")
            ok = ok and rows_equal
        r = r2_radius(a[3])
        hist = torch.bincount((r + 1).long().flatten(),
                              minlength=R2_RADIUS + 2).tolist()
        print(f"kernel ssr_blur {R2_WIDTH}x{R2_HEIGHT} {label} "
              f"[{case['shape']}]: {'bit-equal' if ok else 'DIFFERS'} "
              f"(max_abs_err {case['max_abs_err']:.3g}{note}), "
              f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}: "
              f"{case['bytes'] / 1e6:.1f} MB, {case['ops'] / 1e9:.3f} "
              f"GFLOP; {r2_taps(a[3])} taps inside the radii, "
              f"{a[3].numel() * (2 * R2_RADIUS + 1) ** 2} in the windows); "
              f"pixels by radius -1..{R2_RADIUS} {hist}")
        check(ok, f"r2 {label}: R2 differs from its plain version")
        cases.append(case)
    use = res_usage(kernels.library_path("ssr_blur"), "ssr_blur_kernel")
    print(f"ssr_blur_kernel: {use.get('REG')} registers, "
          f"{use.get('SHARED')} bytes shared, {use.get('LOCAL', 0)} bytes "
          f"local a thread; on {CARD}")
    return cases


def p10_rays(args, kw):
    """probe_trace's plain prelude on a recorded call's arguments: the
    plain march's depth, world positions and rays."""
    from vkr_tpu_torch.passes import probes

    depth, normal, rotated, inv = p10_inputs(args, kw)
    return (depth,) + probes.reflect_rays(rotated, normal, inv)


def p10_inputs(args, kw):
    """P10's inputs on a recorded call's arguments: view_positions' depth,
    normals and rotated view vectors, and the inverse view."""
    from vkr_tpu_torch.passes import probes

    depth, normal, _, inv, fovy, aspect, znear, zfar = args
    return probes.view_positions(depth, normal, inv, fovy, aspect, znear,
                                 zfar, kw.get("row0"),
                                 kw.get("band_h")) + (inv,)


def p10_plain(depth, normal, rotated, inv, grid, settle=False):
    """probe_march's plain version on any device: reflect_rays, then the
    plain march."""
    from vkr_tpu_torch.passes import probes

    return probes.probe_march_reference(
        depth, *probes.reflect_rays(rotated, normal, inv), grid, settle)


def p10_work(rays, grid, settle):
    """What P10 marches on these inputs, each pixel up to its settling pair
    (settle: the plain march's (pair, code) per pixel, pair -1 for sky):
    pixels walked, neighbours visited, pairs marched (a skipped segment is
    not), march steps of those pairs (the plain march's own counts), hits;
    and the engagement counter: pairs marched per walked pixel, and the
    shares of walked pixels that settle at the first pair they march,
    settle later, or march every pair without settling."""
    import torch

    from vkr_tpu_torch.passes import probes

    depth, world_pos, r = rays
    probe_idx, origin, t0, t1 = probes.probe_pairs(world_pos, r, grid)
    start, end = probes._segment_ends(origin[:, None], r, t0, t1)
    _, _, steps = probes._probe_march(grid, probes._mip_tables(grid),
                                      probe_idx[:, None], start, end - start,
                                      probes.TRACE_STEPS)
    n = t0.shape[0] * t0.shape[1]
    marched = ((t1 - t0).abs() >= 0.002).reshape(n, *depth.shape) & (
        torch.arange(n, device=depth.device)[:, None, None]
        <= settle[..., 0])
    pair, code = settle[..., 0], settle[..., 1]
    walked = pair >= 0
    pairs = marched.sum(0)
    n_walked = max(int(walked.sum()), 1)
    return {
        "pixel": int(walked.sum()),
        "neighbour": int(torch.where(
            walked, (pair // 4 + 1).clamp(max=n // 4), 0).sum()),
        "pair": int(pairs.sum()),
        "step": int((steps.reshape(marched.shape) * marched).sum()),
        "hit": int((code == 1).sum()),
        "pairs_per_pixel": int(pairs.sum()) / n_walked,
        "first": int((walked & (pair < n) & (pairs == 1)).sum()) / n_walked,
        "later": int((walked & (pair < n) & (pairs > 1)).sum()) / n_walked,
        "none": int((pair == n).sum()) / n_walked,
        "sky": int((~walked).sum()) / depth.numel(),
    }


def p10_edges(kin, grids):
    """P10 against its plain version, bit for bit with one launch, on P10's
    inputs kin with the rows P10_SKY_ROWS made sky and the normals of
    P10_NAN_ROWS NaN, on each grid: the sky test, and pixels whose rays no
    pair settles, which probe_orbit's frame hardly shows (sky 0, ~0.04%
    never settling). Fails unless both kinds of pixel are there."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.passes import probes

    depth, normal, rotated, inv = kin
    depth, normal = depth.clone(), normal.clone()
    depth[P10_SKY_ROWS] = 1.0
    normal[P10_NAN_ROWS] = math.nan
    for grid in grids:
        before = kernels.LAUNCHES["probe_trace"]
        got, got_settle = probes.probe_march(depth, normal, rotated, inv,
                                             grid, settle=True)
        launched = kernels.LAUNCHES["probe_trace"] - before
        want = p10_plain(depth, normal, rotated, inv, grid, settle=True)
        work = p10_work((depth,) + probes.reflect_rays(rotated, normal, inv),
                        grid, want[1])
        ok = (launched == 1 and same_bits(got, want[0])
              and torch.equal(got_settle, want[1]))
        label = (f"{tuple(depth.shape)} pixels, rows "
                 f"{P10_SKY_ROWS.start}-{P10_SKY_ROWS.stop - 1} sky, normals "
                 f"of rows {P10_NAN_ROWS.start}-{P10_NAN_ROWS.stop - 1} NaN, "
                 f"grid {grid.grid_size}x{grid.grid_size} of "
                 f"{grid.mip_sizes[0]}^2")
        print(f"kernel probe_trace edges [{label}]: "
              f"{'bit-equal' if ok else 'DIFFERS'} (image, settling pair "
              f"and code; {launched} launch); sky {work['sky']:.4f}, walked "
              f"pixels never settling {work['none']:.4f}, settling at the "
              f"first pair {work['first']:.4f}, later {work['later']:.4f}")
        check(ok, f"p10 edges [{label}]: P10 differs from its plain version")
        check(work["sky"] > 0 and work["none"] > 0,
              f"p10 edges [{label}]: no sky or no never-settling pixel")


def p10_phase(device, root):
    """P10 on probe_orbit's frame-1 inputs: BASELINE config 5 at
    P10_WIDTH x P10_HEIGHT, the Sponza stand-in written into root
    (sponza_colonnade_scene as the Sponza phase builds it), the default
    4x4 grid of 256^2 maps, frames 0 and 1 of the bench orbit (eager,
    every kernel), frame 1's probe_trace call recorded. On the whole
    half-res frame and on the band of rank P10_BAND_RANK of P10_BAND_RANKS
    (whose rows must also equal the whole call's): the kernel's image and
    each pixel's settling pair and code equal the plain version's
    (reflect_rays and the plain march) bit for bit, and probe_trace's
    equal probe_trace_reference's; kernel, plain and bound ms of P10
    (probe_march after view_positions); the engagement counter; registers
    and spills. Then p10_edges on the whole frame's inputs with this grid
    and a 2x2 grid of the same scene. Returns the two cases."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_probe_grid, build_ssr_resources
    from vkr_tpu_torch.passes import probes
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import sponza_colonnade_scene

    t_phase = time.perf_counter()
    saved = os.environ.get("VKR_ASSETS")
    os.environ["VKR_ASSETS"] = root
    try:
        scene_np = sponza_colonnade_scene(
            columns=SCENE["columns"], tessellation=SCENE["tessellation"],
            tex_size=SPONZA_TEX)
    finally:
        if saved is None:
            os.environ.pop("VKR_ASSETS", None)
        else:
            os.environ["VKR_ASSETS"] = saved
    scene = upload_scene(scene_np, device)
    cfg = RenderConfig(width=P10_WIDTH, height=P10_HEIGHT,
                       enable_probes=True)
    grid = build_probe_grid(scene_np, cfg, device=device)
    res = build_ssr_resources(cfg.ssr.lut_size, device=device)
    calls = []

    def hook(i):
        if i == CAPTURE_FRAME:
            return Substitute(recording(calls, only=("probe_trace",)))
        return contextlib.nullcontext()
    render(scene, res, cfg, device, CAPTURE_FRAME + 1, on_frame=hook,
           probe_grid=grid)
    check(len(calls) == 1, f"p10: {len(calls)} probe_trace calls recorded "
          f"in {P10_WIDTH}x{P10_HEIGHT} frame {CAPTURE_FRAME}")
    _, args, kw = calls[0]
    H = args[0].shape[0]
    bh = H // P10_BAND_RANKS
    r0 = P10_BAND_RANK * bh
    whole = probes.probe_trace(*args, **kw)
    cases = []
    for label, k in (("whole frame", kw),
                     (f"band of rank {P10_BAND_RANK} of {P10_BAND_RANKS}",
                      dict(kw, row0=r0, band_h=bh))):
        before = kernels.LAUNCHES["probe_trace"]
        traced_img = probes.probe_trace(*args, **k)
        launched = kernels.LAUNCHES["probe_trace"] - before
        traced_ok = same_bits(traced_img,
                              probes.probe_trace_reference(*args, **k))
        kin = p10_inputs(args, k)
        got, got_settle = probes.probe_march(*kin, grid, settle=True)
        want = p10_plain(*kin, grid, settle=True)
        torch.cuda.synchronize()
        ok = (traced_ok and launched == 1 and same_bits(got, want[0])
              and torch.equal(got_settle, want[1]))
        note = ""
        if k.get("row0"):
            rows_equal = same_bits(traced_img, whole[r0:r0 + bh])
            note = (f", rows {'equal' if rows_equal else 'DIFFER FROM'} "
                    "the whole call's")
            ok = ok and rows_equal
        nbytes, ops = work_of("probe_trace", args, k, want)
        work = p10_work(p10_rays(args, k), grid, want[1])
        bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = ops / PEAK_F32_FLOPS * 1e3
        case = {"shape": f"{tuple(kin[0].shape)} pixels, grid "
                         f"{grid.grid_size}x{grid.grid_size} of "
                         f"{grid.mip_sizes[0]}^2"
                         + (f", rows from {r0}" if k.get("row0") else ""),
                "max_abs_err": float((got - want[0]).abs().nan_to_num(
                    nan=math.inf).max()),
                "ms": time_ms(probes.probe_march, kin + (grid,), {}),
                "plain_ms": time_ms(p10_plain, kin + (grid,), {}),
                "library_ms": None,
                "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
                "bytes": nbytes, "ops": ops}
        trace_ms = time_ms(probes.probe_trace, args, k)
        trace_plain_ms = time_ms(probes.probe_trace_reference, args, k)
        print(f"kernel probe_trace {P10_WIDTH}x{P10_HEIGHT} {label} "
              f"[{case['shape']}]: {'bit-equal' if ok else 'DIFFERS'} "
              f"(image, settling pair and code{note}; max_abs_err "
              f"{case['max_abs_err']:.3g}; {launched} launch), P10 "
              f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.4f} GFLOP); probe_trace "
              f"with view_positions {trace_ms:.4f} ms, plain "
              f"{trace_plain_ms:.4f} ms; "
              f"marched: {work['pixel']} pixels, {work['neighbour']} "
              f"neighbours, {work['pair']} pairs, {work['step']} steps, "
              f"{work['hit']} hits; pairs a walked pixel "
              f"{work['pairs_per_pixel']:.4f}; walked pixels settling at "
              f"the first pair {work['first']:.4f}, later "
              f"{work['later']:.4f}, never {work['none']:.4f}; sky "
              f"{work['sky']:.4f}; on {CARD}")
        check(ok, f"p10 {label}: P10 differs from its plain version")
        cases.append(case)
    cfg2 = dataclasses.replace(cfg, probes=dataclasses.replace(cfg.probes,
                                                               grid=2))
    p10_edges(p10_inputs(args, kw),
              (grid, build_probe_grid(scene_np, cfg2, device=device)))
    use = res_usage(kernels.library_path("probe_trace"), "probe_trace_kernel")
    print(f"probe_trace_kernel: {use.get('REG')} registers, "
          f"{use.get('SHARED', 0)} bytes shared, {use.get('LOCAL', 0)} bytes "
          f"local a thread; p10 phase {time.perf_counter() - t_phase:.1f} s")
    return cases


def r1_phase(calls):
    """R1 on RT frame 1's captured calls (name, args, kw): per-ray and 0-d
    t_max tensors held to the plain version; the kernel's walk transcribed
    (rt_walk) with its hits equal to the plain version's and its slot
    tests per ray; the SIMT efficiency of this kernel's lane map (ray
    order: 4 pixels x 8 directions a warp) and of the maps it was measured
    against (one direction of 32 pixels of a row, of 8x4 pixels, of 8x4
    pixels of one dither class); the slot loop's SASS size, registers and
    spills; the operations the tests need by where they end (the bound's),
    against MT_FLOPS_PR15's count; the instruction-issue estimate."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.scene import accel

    grid, o, d, tm = calls[0][1][:4]
    kw = calls[0][2]
    gen = torch.Generator(device=o.device).manual_seed(R1_TMAX_SEED)
    per_ray = float(tm) * (0.25 + 1.25 * torch.rand(
        o.shape[:-1], generator=gen, device=o.device))
    float_hits = accel.ray_any_hit(grid, o, d, tm, **kw)
    for label, t in (("per-ray", per_ray),
                     ("0-d", torch.tensor(float(tm), device=o.device))):
        got = accel.ray_any_hit(grid, o, d, t, **kw)
        want = accel.ray_any_hit_reference(grid, o, d, t, **kw)
        torch.cuda.synchronize()
        err, ok, note = rt_compare(got, want, (grid, o, d, t), kw)
        check(ok, f"R1 with a {label} t_max tensor: {note}")
        if label == "0-d":
            check(torch.equal(got, float_hits), "R1: a 0-d t_max tensor "
                  "gives other hits than the float")
        print(f"R1 t_max {label} tensor [{tuple(t.shape)}]: {note}, hit "
              f"share {float(got.float().mean()):.4f}")

    tests, left = [], collections.Counter()
    for _, args, ckw in calls:
        hits, per, exits = rt_walk(*args[:4], **ckw)
        want = accel.ray_any_hit_reference(*args[:4], **ckw)
        check(torch.equal(hits, want), "R1's walk transcribed (rt_walk) "
              "gives other hits than the plain version")
        tests.append(per.reshape(args[1].shape[:-1]))
        left.update(exits)
    n_tests = sum(int(t.sum()) for t in tests)
    n_rays = sum(t.numel() for t in tests)
    pixels, dirs = tests[0].shape[:-1].numel(), tests[0].shape[-1]
    n = tests[0].numel()
    in_order = torch.arange(-(-n // 32) * 32)
    in_order = torch.where(in_order < n, in_order, -1)
    h, w = tests[0].shape[:2]
    maps = (("ray order (this kernel)", in_order),
            ("one direction, 32 pixels of a row", rt_lane_rays(pixels, dirs)),
            ("one direction, 8x4 pixels", tile_lane_rays(h, w, dirs, 8, 4)),
            ("one direction, 8x4 pixels of one dither class",
             tile_lane_rays(h, w, dirs, 8, 4, stride=4)))
    simt = {label: statistics.fmean(lane_efficiency(t.reshape(-1), m)
                                    for t in tests) for label, m in maps}
    print(f"R1 slot tests on RT frame 1's {len(calls)} calls: {n_tests} "
          f"({n_tests / n_rays:.3f} a ray; per ray in call 0 "
          f"{quantiles(tests[0])}); tests leaving after det {left['det']}, "
          f"before the division {left['a']}, after u {left['u']}, after v "
          f"{left['v']}, forming t "
          f"{left['t']}; SIMT efficiency (tests / 32 x the warp's most): "
          + ", ".join(f"{k} {v:.4f}" for k, v in simt.items()))
    ops = sum(MT_OPS[k] * v for k, v in left.items())
    print(f"R1 operations by where the tests end ({MT_OPS}): {ops} "
          f"({ops / n_tests:.3f} a test), {ops / PEAK_F32_FLOPS * 1e3:.4f} ms"
          f" a frame at the float32 peak; PR 15's count ({MT_FLOPS_PR15} a "
          f"test, the edges included, every test in full) "
          f"{n_tests * MT_FLOPS_PR15 / PEAK_F32_FLOPS * 1e3:.4f} ms")

    lib = kernels.library_path("ray_any_hit")
    size, rcp, per_test = slot_test_loop(lib)
    usage = res_usage(lib)
    print(f"R1 SASS loop bodies {sass_loops(lib)['ray_any_hit_kernel'][1]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    max_mhz, now_mhz = (float(v) for v in smi.stdout.split(",")[:2])
    est_ms = per_test * n_tests / (ISSUE_PER_CLOCK * max_mhz * 1e6) * 1e3
    print(f"R1 SASS: slot loop {size} instructions, {rcp} reciprocal(s): "
          f"{per_test:.1f} instructions a test; {usage} (cuobjdump "
          f"-res-usage); instruction-issue estimate {per_test:.1f} x "
          f"{n_tests} / (132 SMs x 4 x 32 x {max_mhz:.0f} MHz, the SM "
          f"clock's maximum; {now_mhz:.0f} MHz now) = {est_ms:.4f} ms a "
          f"frame at full SIMT efficiency, "
          f"{est_ms / simt['ray order (this kernel)']:.4f} "
          f"ms at this map's ({CARD})")


def stress_rows(device, n_pairs, w, seed):
    """One 8 x w tile holding n_pairs pair rows, built by the port's own
    triangle setup (fill-rule biased c) from corners on pixel centres, so
    edges run through pixel centres. Large triangles get random depth
    planes in [0.3, 0.95], or (a third of them) the constant depth 0.25:
    equal depths over most of the tile, decided by segment order. One in
    500 is a small triangle of depth +0.0 or -0.0 (every plane coefficient
    -0.0 evaluates to -0.0): where they overlap, the two zeros tie."""
    import numpy as np
    import torch

    from vkr_tpu_torch.raster import setup

    rng = np.random.default_rng(seed)
    h, pad = 8, w * 5 // 16
    kind = rng.integers(0, 1000, n_pairs)  # 0: +0.0, 1: -0.0, 2-333: 0.25
    small = kind <= 1
    cx = rng.integers(0, w, n_pairs)
    cy = rng.integers(0, h, n_pairs)
    xs = np.where(small, cx + rng.integers(-5, 6, (3, n_pairs)),
                  rng.integers(-pad, w + pad, (3, n_pairs))) + 0.5
    ys = np.where(small, cy + rng.integers(-5, 6, (3, n_pairs)),
                  rng.integers(-24, 32, (3, n_pairs))) + 0.5
    zs = rng.uniform(0.3, 0.95, (3, n_pairs))
    corners = [[torch.tensor(v, dtype=torch.float32) for v in (
        xs[c] * 2.0 / w - 1.0, ys[c] * 2.0 / h - 1.0, zs[c],
        np.ones(n_pairs))] for c in range(3)]
    st = setup.triangle_setup_t(corners, torch.ones(n_pairs, dtype=torch.bool),
                                w, h)
    rows = torch.zeros((n_pairs, 64), dtype=torch.float32)
    for i, v in enumerate(list(st.a) + list(st.b) + list(st.c)
                          + list(st.zplane)):
        rows[:, i] = v
    for sel, z in ((kind == 0, 0.0), (kind == 1, -0.0),
                   ((kind >= 2) & (kind <= 333), 0.25)):
        sel = torch.as_tensor(sel)
        rows[sel, 9:11] = math.copysign(0.0, z)
        rows[sel, 11] = z
    rows[:, 12] = torch.arange(n_pairs, dtype=torch.float32)
    rows[:, 16:19] = torch.tensor([0.0, 0.0, 1.0])
    rows[:, 19:46] = torch.tensor(rng.uniform(-1, 1, (n_pairs, 27)),
                                  dtype=torch.float32)
    rows[:, 46] = torch.tensor(rng.integers(0, 8, n_pairs),
                               dtype=torch.float32)
    return (rows.to(device),
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.full((1,), n_pairs, dtype=torch.int32, device=device))


def stress_peel(device, w, seed):
    """An 8 x w peel floor: none (-1), 0.0 (peels both zeros), the tie
    depth 0.25, or random in [0.3, 0.7]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    floor = rng.choice([-1.0, 0.0, 0.25, 0.5], (8, w))
    floor[floor == 0.5] = rng.uniform(0.3, 0.7, int((floor == 0.5).sum()))
    return torch.tensor(floor, dtype=torch.float32, device=device)


def sass_loops(lib):
    """{kernel: (instructions, loop bodies longest first)} of a built
    library (a csrc name, or the path of a library), from cuobjdump -sass:
    a loop body is the instructions that a backward branch spans."""
    from vkr_tpu_torch import kernels

    text = sass_text(lib if str(lib).endswith(".so")
                     else kernels.library_path(lib))
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        short = re.search(r"\d([a-z_]+_kernel)(ILb([01])E)?", name)
        if short:
            name = short.group(1) + (
                "" if short.group(3) is None
                else ("<true>" if short.group(3) == "1" else "<false>"))
        insns = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, ins in insns:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < addr:
                loops.append(sum(1 for a, _ in insns
                                 if int(m.group(1), 16) <= a <= addr))
        out[name] = (sum(1 for _, i in insns if not re.search(r"\bNOP\b", i)),
                     sorted(loops, reverse=True))
    return out


def library_call(name, args, kw):
    """One PyTorch call computing the same function on the same inputs,
    where there is one: F.grid_sample (bilinear, border padding, pixel
    centres) for K4 and K5. The sample positions are built outside the
    call. None for K1, K6, K7 and the march: no single PyTorch call walks
    binned triangles or marches a hi-Z pyramid, and K6's six taps with
    their texel offsets are six calls."""
    import torch
    import torch.nn.functional as F

    if name not in ("window_gather_bilinear", "window_gather_bilinear_multi"):
        return None
    img, off_y, off_x = args[:3]
    h, w = img.shape[:2]
    row0 = kw.get("row0", 0)
    ys = torch.arange(row0, row0 + off_y.shape[-2], device=img.device,
                      dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=img.device, dtype=torch.float32)
    gx = (xs + off_x + 0.5) / w * 2.0 - 1.0
    gy = (ys + off_y + 0.5) / h * 2.0 - 1.0
    grid = torch.stack([gx, gy], -1).reshape(1, -1, w, 2)
    src = (img.permute(2, 0, 1) if img.ndim == 3 else img[None])[None]
    src = src.contiguous()

    def call():
        return F.grid_sample(src, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)
    return call


def corner_scene(h, w, device):
    """vkr_tpu's analytic GTAO input (tests/test_passes.py synthetic_scene):
    a floor and a wall 2.5 ahead, ray-cast at close range from a camera at
    (0, 1.2, -1.5), at h x w with square pixels. Returns depth (h, w),
    octahedral normals (h, w, 2) and the GTAOParams' fields."""
    import numpy as np
    import torch

    from vkr_tpu_torch.mathlib.octahedral import encode_normal
    from vkr_tpu_torch.mathlib.transforms import look_at, normal_matrix

    fovy, aspect, zn, zf = math.radians(60.0), w / h, 0.05, 80.0
    view = look_at((0, 1.2, -1.5), (0, 0.5, 1.0), (0, -1, 0))
    inv = np.linalg.inv(view.astype(np.float64))
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    tg = math.tan(fovy / 2)
    dir_cam = np.stack([-(2 * xs - 1) * tg * aspect, -(2 * ys - 1) * tg,
                        -np.ones_like(xs)], -1)
    dir_world = dir_cam @ inv[:3, :3].T
    org = inv[:3, 3]
    with np.errstate(divide="ignore"):
        t_floor = np.where(dir_world[..., 1] < 0,
                           -org[1] / dir_world[..., 1], 1e9)
        t_wall = np.where(dir_world[..., 2] > 0,
                          (2.5 - org[2]) / dir_world[..., 2], 1e9)
    y_wall = org[1] + t_wall * dir_world[..., 1]
    t_wall = np.where((y_wall >= 0) & (y_wall <= 2.0), t_wall, 1e9)
    t = np.minimum(t_floor, t_wall)
    depth = np.clip(zf / (zf - zn) + zf * zn / (-t * (zf - zn)), 0, 1)
    nrm = np.where((t_wall < t_floor)[..., None], [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0])
    noct = encode_normal(torch.as_tensor(nrm, dtype=torch.float32,
                                         device=device))
    return (torch.as_tensor(depth, dtype=torch.float32, device=device), noct,
            (torch.as_tensor(normal_matrix(view), device=device), fovy,
             aspect, zn, zf))


def light_view_proj():
    """A light at shading's LIGHT_POS looking straight down over the hall
    (90 degrees, near 0.5, far 40), float32."""
    import numpy as np

    from vkr_tpu_torch.mathlib.transforms import look_at, perspective
    from vkr_tpu_torch.passes.shading import LIGHT_POS

    eye = np.asarray(LIGHT_POS, np.float32)
    view = look_at(eye, eye - np.asarray([0.0, 1.0, 0.0], np.float32),
                   (0.0, 0.0, 1.0))
    return (perspective(np.radians(90.0), 1.0, 0.5, 40.0) @ view).astype(
        np.float32)


# glTF phase: the colonnade written as .gltf + .bin + PNG textures
GLTF_FILTERS = (0, 1, 2, 3, 4)  # PNG row filters, taken in turn by row
GL_WRAP = {0: 10497, 1: 33071}  # WRAP_REPEAT, WRAP_CLAMP -> glTF wrapS
GLTF_FRAMES = 3
# textures written at 2048x512 with CLAMP (the columns' and capitals'
# albedo and their MR); the others at 1024x1024 with REPEAT
GLTF_WIDE = (3, 4, 7)
# the material textures' shapes after load_scene(tex_size=1024,
# native_sizes=True): 2048x512 halves to 1024x256
GLTF_NATIVE = [(1024, 1024)] * 3 + [(256, 1024)] * 2 + [(1024, 1024)] * 2 \
    + [(256, 1024)]
# trilinear must move the albedo of at least this share of the pixels
MIN_TRILINEAR_SHARE = 0.01


def write_gltf(directory, scene, images, wraps, data_uri=(), buffer_view=(),
               name="scene"):
    """Write the geometry, materials and draw calls of a GltfScene as
    <directory>/<name>.gltf with one <name>.bin, texture t showing
    images[t] (RGBA8, written as PNG; or the bytes of an encoded PNG or
    JPEG, written as they are) with wrap mode wraps[t] (WRAP_*).
    Images go in files, except those in data_uri (base64 data: URIs) and
    buffer_view (PNG bytes in the .bin). Positions and normals interleave
    in one strided buffer view; each draw call is a node with its matrix.
    Returns the .gltf path."""
    import base64
    import json
    import os

    import numpy as np

    from vkr_tpu_torch.core.readback import png_bytes

    blob = bytearray()

    def view(data: bytes, stride=None):
        while len(blob) % 4:
            blob.append(0)
        v = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        blob.extend(data)
        views.append(v)
        return len(views) - 1

    views, accessors = [], []

    def accessor(view_id, offset, count, kind, component=5126):
        accessors.append({"bufferView": view_id, "byteOffset": offset,
                          "count": int(count), "type": kind,
                          "componentType": component})
        return len(accessors) - 1

    pos_nrm = np.concatenate([scene.positions, scene.normals], 1)
    v_interleaved = view(np.ascontiguousarray(pos_nrm, "<f4").tobytes(), 24)
    v_uv = view(np.ascontiguousarray(scene.uvs, "<f4").tobytes())
    v_idx = view(np.ascontiguousarray(scene.indices, "<u4").tobytes())
    meshes = []
    for prims in scene.meshes:
        out = []
        for p in prims:
            idx = scene.indices[p.index_offset:p.index_offset + p.index_count]
            n = int(idx.max()) + 1 if len(idx) else 0
            out.append({
                "attributes": {
                    "POSITION": accessor(v_interleaved, 24 * p.vertex_offset,
                                         n, "VEC3"),
                    "NORMAL": accessor(v_interleaved,
                                       24 * p.vertex_offset + 12, n, "VEC3"),
                    "TEXCOORD_0": accessor(v_uv, 8 * p.vertex_offset, n,
                                           "VEC2")},
                "indices": accessor(v_idx, 4 * p.index_offset, len(idx),
                                    "SCALAR", 5125),
                "material": p.material, "mode": 4})
        meshes.append({"primitives": out})
    gl_images = []
    for t, img in enumerate(images):
        if isinstance(img, bytes):
            data = img
        else:
            data = png_bytes(img, filters=GLTF_FILTERS, level=1)
        ext = "jpeg" if data[:2] == b"\xff\xd8" else "png"
        if t in data_uri:
            gl_images.append({"uri": f"data:image/{ext};base64,"
                              + base64.b64encode(data).decode()})
        elif t in buffer_view:
            gl_images.append({"bufferView": view(data),
                              "mimeType": f"image/{ext}"})
        else:
            fname = f"{name}_tex{t}.{ext.replace('jpeg', 'jpg')}"
            with open(os.path.join(directory, fname), "wb") as f:
                f.write(data)
            gl_images.append({"uri": fname})
    samplers = [{"wrapS": GL_WRAP[w], "wrapT": GL_WRAP[w]}
                for w in sorted(set(wraps))]
    sampler_of = {w: i for i, w in enumerate(sorted(set(wraps)))}
    materials = []
    for m in scene.materials:
        pbr = {}
        if m.albedo_tex >= 0:
            pbr["baseColorTexture"] = {"index": m.albedo_tex}
        if m.mr_tex >= 0:
            pbr["metallicRoughnessTexture"] = {"index": m.mr_tex}
        mat = {"pbrMetallicRoughness": pbr}
        if m.clip_alpha:
            mat.update(alphaMode="MASK", alphaCutoff=m.alpha_cutoff)
        materials.append(mat)
    nodes = [{"mesh": dc.mesh,
              "matrix": np.asarray(dc.transform, np.float64).T
              .reshape(-1).tolist()} for dc in scene.draw_calls]
    with open(os.path.join(directory, f"{name}.bin"), "wb") as f:
        f.write(bytes(blob))
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
        "meshes": meshes, "materials": materials,
        "textures": [{"source": t, "sampler": sampler_of[w]}
                     for t, w in enumerate(wraps)],
        "samplers": samplers, "images": gl_images,
        "buffers": [{"uri": f"{name}.bin", "byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors,
    }
    path = os.path.join(directory, f"{name}.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def gltf_textures(images):
    """The colonnade's own images at two native sizes: GLTF_WIDE at
    2048x512 (every other row, each texel twice along x) with CLAMP, the
    rest as they are (1024x1024) with REPEAT. Returns (images, wraps)."""
    import numpy as np

    out, wraps = list(images), [0] * len(images)
    for t in GLTF_WIDE:
        out[t] = np.repeat(images[t][::2], 2, axis=1)
        wraps[t] = 1
    return out, wraps


@contextlib.contextmanager
def returns(mod, attr, log):
    """Keep what each call of mod.attr returns while the block runs."""
    fn = getattr(mod, attr)

    def kept(*args, **kw):
        log.append(fn(*args, **kw))
        return log[-1]
    setattr(mod, attr, kept)
    try:
        yield
    finally:
        setattr(mod, attr, fn)


def gltf_phase(cfg, res, device, tmp):
    """Writes the bench colonnade as glTF, loads it with native-size
    textures, renders GLTF_FRAMES trilinear frames and holds the indexed
    front end to the corner path. The files go into the directory tmp.
    Returns (scene, config, outputs, the .gltf path)."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.passes import gbuffer as gbuffer_mod
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer, upload_scene
    from vkr_tpu_torch.raster import gbuf_kernel
    from vkr_tpu_torch.scene import scene as scene_mod
    from vkr_tpu_torch.scene.procedural import build_colonnade
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    t0 = time.perf_counter()
    src = build_colonnade(**SCENE)
    images, wraps = gltf_textures(src.images)
    path = write_gltf(tmp, src, images, wraps)
    write_s = time.perf_counter() - t0
    file_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
    t0 = time.perf_counter()
    scene_np = scene_mod.load_scene(path, tex_size=SCENE["tex_size"],
                                    native_sizes=True)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = upload_scene(scene_np, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tex = scene.tex
    tex_bytes = sum(t.numel() * t.element_size()
                    for t in (tex.texels, tex.level_off, tex.level_w,
                              tex.level_h, tex.wrap))
    n_tri = len(scene.tri_opaque_mat) + len(scene.tri_masked_mat)
    shapes = [im.shape[:2] for im in scene_np.tex_images]
    print(f"gltf: wrote {path.rsplit('/', 1)[-1]} + .bin + "
          f"{len(images)} PNG ({file_bytes} bytes, rows under filters "
          f"{GLTF_FILTERS}) in {write_s:.3f} s; load_scene {load_s:.3f} s; "
          f"upload {upload_s:.3f} s; "
          f"{n_tri} triangles ({len(scene.tri_masked_mat)} alpha-MASK); "
          f"native textures {shapes}, {tex.n_levels} levels, pairs "
          f"{tex.paired}; texture bytes on the card {tex_bytes}")
    check(n_tri == SCENE_TRIANGLES
          and len(scene.tri_masked_mat) == SCENE_MASKED,
          f"gltf: {n_tri} triangles, {len(scene.tri_masked_mat)} masked")
    check(shapes == GLTF_NATIVE, f"gltf: native texture shapes {shapes}")
    check(tex.paired and tex.base_size is None,
          "gltf: the native set did not pair every material")

    cfg_gltf = dataclasses.replace(cfg, trilinear_textures=True)
    kernels.LAUNCHES.clear()
    outs = render(scene, res, cfg_gltf, device, GLTF_FRAMES)
    launches = dict(kernels.LAUNCHES)
    check_frames(outs, launches, GLTF_FRAMES, MIN_LAUNCHES_PER_FRAME, "gltf")
    bilinear = render(scene, res, cfg, device, GLTF_FRAMES)
    share = [float((o["albedo"] != b["albedo"]).any(-1).float().mean())
             for o, b in zip(outs, bilinear)]
    check(min(share) > MIN_TRILINEAR_SHARE, f"gltf: trilinear changed the "
          f"albedo of {share} of the pixels")
    same_geometry = all(torch.equal(o["depth"], b["depth"])
                        for o, b in zip(outs, bilinear))
    print(f"gltf: {GLTF_FRAMES} frames (trilinear_textures, SSR on, MIS "
          f"GTAO), launches {launches}; share of pixels whose albedo "
          f"trilinear changed per frame {[round(x, 4) for x in share]} "
          f"(depth unchanged: {same_geometry})")

    # one G-buffer through the indexed front end, K1's outputs recorded
    i = WARMUP_FRAMES
    cam = camera_frame(cfg_gltf, bench_orbit_view(i),
                       bench_orbit_view(i - 1), i, device)
    indexed = scene._replace(corner_world_o=None, corner_attr_o=None,
                             corner_world_m=None, corner_attr_m=None)
    kw = dict(width=WIDTH, height=HEIGHT, quantize=cfg.quantize_formats,
              mask_peel_layers=cfg.raster.mask_peel_layers, trilinear=True)
    k1 = {}
    for label, sc in (("corner", scene), ("indexed", indexed)):
        calls = k1[label] = []

        def keep(name, wrapper, plain, calls=calls):
            if name != "gbuf_tiles":
                return wrapper

            def rec(*args, **kwargs):
                out = wrapper(*args, **kwargs)
                calls.append(out)
                return out
            return rec
        kernels.LAUNCHES.clear()
        with Substitute(keep):
            gb = render_gbuffer(sc, cam.mvp, cam.prev_mvp, cam.jitter, **kw)
        torch.cuda.synchronize()
        k1[label + " gbuffer"] = gb
        check(kernels.LAUNCHES.get("gbuf_tiles", 0) == 3, f"gltf {label} "
              f"G-buffer: K1 launched {dict(kernels.LAUNCHES)}")
    worst = 0.0
    for (z, tid, attrs), (z0, tid0, attrs0) in zip(k1["indexed"],
                                                   k1["corner"]):
        worst = max(worst, float((attrs - attrs0).abs().max()))
        check(torch.equal(z, z0) and torch.equal(tid, tid0)
              and bool(((attrs - attrs0).abs()
                        <= 1e-6 + 1e-6 * attrs0.abs()).all()),
              "gltf: the indexed front end's K1 outputs differ from the "
              "corner path's")
    g, g0 = k1["indexed gbuffer"], k1["corner gbuffer"]
    gdiff = {k: float((getattr(g, k) - getattr(g0, k)).abs().max())
             for k in FRAME_CHANNELS[:5]}
    check(torch.equal(g.depth, g0.depth), "gltf: indexed G-buffer depth "
          "differs from the corner path's")
    print(f"gltf: indexed front end (corner tables dropped) vs corner "
          f"path, frame {i}: K1 depth and ids equal on its 3 calls, "
          f"attributes max |diff| {worst:.3g}; G-buffer max |diff| {gdiff}")
    return scene, cfg_gltf, outs, path


# JPEG glTF phase: the glTF phase's colonnade with its 8 textures from the
# committed JPEGs of tests/torch_images (make_images.py), held to the
# digests of PIL's convert("RGBA") in its digests.json
JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_images")
JPEG_FRAMES = 3


class FrameLaunches:
    """on_frame hook for render(): the kernel launches of each frame by
    wrapper (per_frame), around an optional inner hook."""

    def __init__(self, inner=None):
        self.per_frame, self.inner = [], inner

    def __call__(self, i):
        from vkr_tpu_torch import kernels

        stack = contextlib.ExitStack()
        before = dict(kernels.LAUNCHES)
        stack.callback(lambda: self.per_frame.append(
            {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}))
        if self.inner is not None:
            stack.enter_context(self.inner(i))
        return stack


def device_time(prof):
    """(device ms, kernels and copies) of a finished torch.profiler run."""
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def aot_check(scene, res, cfg, device):
    """Main frame 0 through aot.cached_jit against the direct call: every
    output tensor bit-equal. Returns the cached_jit seconds."""
    import torch

    from vkr_tpu_torch.core.aot import cached_jit
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.graph import _leaves
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    cam = camera_frame(cfg, bench_orbit_view(0), bench_orbit_view(0), 0,
                       device)
    args = (scene, FrameState.initial(HEIGHT, WIDTH, device), cam, res, cfg)
    t0 = time.perf_counter()
    frame = cached_jit("render_frame", render_frame, args, verbose=True)
    aot_s = time.perf_counter() - t0
    direct = [t for t in _leaves(render_frame(*args))
              if isinstance(t, torch.Tensor)]
    via = [t for t in _leaves(frame(*args)) if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    check(len(via) == len(direct) > 0
          and all(a.shape == b.shape and a.dtype == b.dtype
                  and torch.equal(a, b) for a, b in zip(via, direct)),
          "aot: the frame through cached_jit differs from the direct call")
    return aot_s, len(via)


# The traced frame's kernels by CUDA symbol, per profiled replay: K1's walk
# (merged raster and resolve), the march, K4, K5, K6 and R1.
TRACED_SYMBOLS = {"gbuf_tiles": "walk_kernel<true>",
                  "hierarchical_march": "ssr_march_kernel",
                  "window_gather_bilinear_multi": "window_gather_multi_kernel",
                  "window_gather_bilinear": "window_gather_k5",
                  "taa_history_gather": "taa_history_gather_kernel",
                  "ray_any_hit": "ray_any_hit_kernel",
                  "ssr_blur": "ssr_blur_kernel",
                  "probe_trace": "probe_trace_kernel"}
TRACED_FRAMES = 8
TRACED_OTHER_FRAMES = 3  # the SSR-off, trilinear and probe frames
SYNC_FRAME = 2


def _frame_tensors(color, state, aux, to=None):
    """Every tensor a frame returns (the colour, each FrameState field,
    aux's tensors and G-buffer), cloned, or copied to the device `to`."""
    import torch

    ts = [color] + [getattr(state, f) for f in state.FIELDS]
    for k in sorted(aux):
        v = aux[k]
        ts += (list(v) if isinstance(v, tuple) else [v])
    return [t.clone() if to is None else t.to(to) for t in ts
            if isinstance(t, torch.Tensor)]


def graph_nodes(frame):
    """Nodes of a graph of the captured frame, over all its segments: its
    first graph's body recorded once more (CapturedFrame.record) into
    torch.cuda.CUDAGraph(keep_graph=True) segments, the only kind whose
    cudaGraph_t PyTorch keeps, each counted with cudaGraphGetNodes (the
    libcudart this process loaded, else the toolkit's). None where this
    PyTorch has no keep_graph."""
    import ctypes
    import glob

    import torch

    from vkr_tpu_torch.core import aot

    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    graph, _, _ = frame.record(0, aot._CudaGraphs(keep_graph=True))
    with open("/proc/self/maps") as f:
        libs = sorted({ln.split()[-1] for ln in f if "libcudart" in ln})
    libs += glob.glob("/usr/local/cuda/lib64/libcudart.so*")
    rt = ctypes.CDLL(libs[0])
    total = 0
    for segment in graph.graphs:
        n = ctypes.c_size_t(0)
        err = rt.cudaGraphGetNodes(ctypes.c_void_p(segment.raw_cuda_graph()),
                                   None, ctypes.byref(n))
        check(err == 0, f"cudaGraphGetNodes: CUDA error {err}")
        total += n.value
    return total


def profiled_replay(label, call, symbols):
    """call() (a replay) under torch.profiler, synchronised: (device ms,
    kernels and copies, runs of each TRACED_SYMBOLS kernel by CUDA name,
    call's result). Fails unless each wrapper of `symbols` (wrapper ->
    launches) ran at least that many times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    device_ms, n_ops = device_time(prof)
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.self_device_time_total > 0]
    seen = {w: sum(n for k, n in names if sym in k)
            for w, sym in TRACED_SYMBOLS.items()}
    for wrapper, want in symbols.items():
        check(seen[wrapper] >= want, f"{label}: a profiled replay ran "
              f"{TRACED_SYMBOLS[wrapper]} {seen[wrapper]} times, not {want}")
    return device_ms, n_ops, seen, out


def traced_phase(label, scene, res, cfg, device, n_frames, symbols,
                 probe_grid=None, tri_grid=None):
    """The frame through core/aot.py:cached_jit (captured, replayed, the
    FrameState donated) against the eager frame: n_frames of the bench
    orbit, every output tensor bit-equal per frame, overflow 0 on every
    replay; frame SYNC_FRAME's eager body at the captured capacities under
    set_sync_debug_mode("error"); one replay under torch.profiler, whose
    kernels must hold each of `symbols` (wrapper -> launches) by its CUDA
    name. Returns the phase's seconds."""
    import torch

    from vkr_tpu_torch.core.aot import CapturedFrame, cached_jit
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.raster import setup
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    def fn(s, st, c):
        return render_frame(s, st, c, res, cfg, probe_grid=probe_grid,
                            tri_grid=tri_grid)

    def cam(i):
        return camera_frame(cfg, bench_orbit_view(i),
                            bench_orbit_view(max(i - 1, 0)), i, device)

    t_phase = time.perf_counter()
    state, eager, counts = FrameState.initial(HEIGHT, WIDTH, device), [], []
    for i in range(n_frames):
        plan = setup.PairPlan()
        with setup.pair_plan(plan):
            out = fn(scene, state, cam(i))
        state = out[1]
        eager.append(_frame_tensors(*out))
        counts.append(plan.counts)
        if i == SYNC_FRAME - 1:
            # the traced body of frame SYNC_FRAME must not synchronise
            caps = setup.static_capacities(counts[0])
            c2 = cam(SYNC_FRAME)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with setup.pair_plan(setup.PairPlan(caps)):
                    fn(scene, state, c2)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()

    state = FrameState.initial(HEIGHT, WIDTH, device)
    cam0 = cam(0)
    frame = cached_jit(f"traced {label}", fn, (scene, state, cam0),
                       donate_argnums=(1,))
    check(isinstance(frame, CapturedFrame),
          f"traced {label}: cached_jit did not capture the frame")
    for i in range(n_frames):
        color, state, aux = frame(scene, state, cam0 if i == 0 else cam(i))
        torch.cuda.synchronize()
        got = _frame_tensors(color, state, aux)
        same = len(got) == len(eager[i]) and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, eager[i]))
        check(same, f"traced {label} frame {i}: differs from the eager frame")
        check(int(aux["overflow"]) == 0, f"traced {label} frame {i}: "
              f"{int(aux['overflow'])} bin pairs dropped")
    torch.cuda.empty_cache()  # the graphs' pools stay while they live
    pool_bytes = torch.cuda.memory_reserved() - reserved
    del eager

    c = cam(n_frames)
    device_ms, n_ops, seen, (color, state, aux) = profiled_replay(
        f"traced {label}", lambda: frame(scene, state, c), symbols)
    check(int(aux["overflow"]) == 0, f"traced {label}: overflow in the "
          "profiled replay")
    phase_s = time.perf_counter() - t_phase
    print(f"traced {label}: {n_frames} frames through cached_jit equal the "
          f"eager frames bit for bit (colour, FrameState, aux), overflow 0; "
          f"frame {SYNC_FRAME}'s body clean under set_sync_debug_mode"
          f"('error'); capture {frame.capture_seconds:.3f} s (warm-up and "
          f"two graphs), graph nodes per frame {graph_nodes(frame)}, a "
          f"replay's device {device_ms:.3f} ms in {n_ops} kernels and "
          f"copies, kernels by symbol {seen}, graph pools and buffers "
          f"{pool_bytes} bytes, bin-pair capacities {frame.capacities} for "
          f"the capture frame's {counts[0]}; {phase_s:.1f} s")
    return phase_s


def jpeg_gltf_phase(cfg, res, device, tmp):
    """The glTF phase's colonnade with the committed JPEG textures: every
    decoded texture held to PIL's digest, JPEG_FRAMES default frames with
    the main phase's checks and each frame's own launches. Returns (scene,
    outputs)."""
    import hashlib

    import numpy as np
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import gltf as gltf_mod
    from vkr_tpu_torch.scene import scene as scene_mod
    from vkr_tpu_torch.scene.procedural import build_colonnade

    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    files = sorted((v["texture"], name) for name, v in digests.items()
                   if isinstance(v, dict) and "texture" in v)
    jpegs = []
    for _, name in files:
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            jpegs.append(f.read())
    src = build_colonnade(**SCENE)
    _, wraps = gltf_textures(src.images)
    check(len(jpegs) == len(src.images),
          f"jpeg gltf: {len(jpegs)} JPEGs for {len(src.images)} textures")
    path = write_gltf(tmp, src, jpegs, wraps, name="jpeg")

    decoded = []
    t0 = time.perf_counter()
    with returns(gltf_mod, "_decode_image", decoded):
        scene_np = scene_mod.load_scene(path, tex_size=SCENE["tex_size"],
                                        native_sizes=True)
    load_s = time.perf_counter() - t0
    for (t, name), img in zip(files, decoded):
        want = digests[name]
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        check(list(img.shape) == want["shape"] and img.dtype == np.uint8
              and got == want["rgba_sha256"],
              f"jpeg gltf: {name} ({want['form']}) decoded to "
              f"{img.shape} {got}, not PIL's {want['rgba_sha256']}")
    check(len(decoded) == len(files), f"jpeg gltf: {len(decoded)} images "
          f"decoded of {len(files)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = upload_scene(scene_np, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    shapes = [im.shape[:2] for im in scene_np.tex_images]
    n_tri = len(scene.tri_opaque_mat) + len(scene.tri_masked_mat)
    print(f"jpeg gltf: {len(files)} committed JPEGs ("
          + "; ".join(f"{name}: {digests[name]['form']}, "
                      f"{len(data)} bytes"
                      for (_, name), data in zip(files, jpegs))
          + f"), each decoded to PIL's digest ({digests['made_with']}); "
          f"load_scene {load_s:.3f} s; upload "
          f"{upload_s:.3f} s; {n_tri} triangles; native textures {shapes}")
    check(n_tri == SCENE_TRIANGLES and shapes == GLTF_NATIVE
          and scene.tex.paired, f"jpeg gltf: {n_tri} triangles, native "
          f"shapes {shapes}, pairs {scene.tex.paired}")

    hook = FrameLaunches()
    kernels.LAUNCHES.clear()
    outs = render(scene, res, cfg, device, JPEG_FRAMES, on_frame=hook)
    launches = dict(kernels.LAUNCHES)
    check_frames(outs, launches, JPEG_FRAMES, MIN_LAUNCHES_PER_FRAME,
                 "jpeg gltf")
    for i, per in enumerate(hook.per_frame):
        for name, n in MIN_LAUNCHES_PER_FRAME.items():
            check(per.get(name, 0) >= n, f"jpeg gltf frame {i}: {name} "
                  f"launched {per.get(name, 0)} times")
    print(f"jpeg gltf: {JPEG_FRAMES} frames (RenderConfig(), SSR on, MIS "
          f"GTAO), coverage "
          f"{[round(float((o['depth'] < 1.0).float().mean()), 4) for o in outs]}"
          f", overflow 0, launches per frame {hook.per_frame}")
    return scene, outs


# Sponza phase: bench.py's default workload (sponza_colonnade_scene, 24
# columns, tessellation 80, 1024² textures) on a stand-in in Sponza's
# layout: Sponza/glTF/Sponza.gltf with Sponza's 25 materials and 69 images
# (the reference's real textures are not in this repository)
SPONZA_MATERIALS = 25
SPONZA_IMAGES = 69
SPONZA_FRAMES = 3
SPONZA_TEX = 1024
SPONZA_PROFILE_REPS = 2  # the tools phase's profile --scene sponza --reps
# PNG sizes of the stand-in, (height, width), taken in turn: resizes to
# 1024² go down, up, across and stay
SPONZA_PNG_SIZES = ((512, 512), (1024, 1024), (1024, 2048), (512, 256))
# PNG forms, taken in turn: (colour type, label)
SPONZA_PNG_FORMS = ((2, "RGB"), (0, "grey"), (3, "palette"),
                    (3, "palette with tRNS"), (4, "grey+alpha"))
# the MASK materials and their alphaCutoff (None: absent, 0.5); the first
# one is the colonnade foliage's
SPONZA_MASKS = {2: 0.3, 9: None, 16: 0.7}
SPONZA_NO_MR = (20, 21, 22, 23, 24)  # no metallicRoughnessTexture
SPONZA_NO_ALBEDO = (24,)          # no baseColorTexture


def standin_jpegs():
    """The committed JPEGs the stand-in takes, (name, form): the 8
    colonnade textures and every item-18 form PIL decodes."""
    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    return [(k, v["form"]) for k, v in sorted(digests.items())
            if isinstance(v, dict) and v.get("pil", "decodes") == "decodes"]


def _standin_pixels(rng, h, w, channels):
    """Seeded waves: (h, w, channels) u8."""
    import numpy as np

    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((h, w, channels), np.uint8)
    for c in range(channels):
        fx, fy = rng.uniform(1.0, 9.0, 2).astype(np.float32)
        phase = np.float32(rng.uniform(0.0, 6.3))
        out[..., c] = (127.5 + 127.0 * np.sin(
            np.float32(6.2832) * (fx * x + fy * y) + phase)).astype(np.uint8)
    return out


def write_sponza_standin(root, seed=0, size_scale=1.0):
    """Write root/Sponza/glTF/Sponza.gltf in Sponza's layout: 25
    materials (pbrMetallicRoughness albedo and metallic-roughness
    textures, normalTexture, MASK with and without alphaCutoff, some with
    no metallic-roughness or no base-colour texture), 69 textures whose
    sources are a seeded derangement of the 69 images, one REPEAT
    sampler, no geometry. The images are the committed JPEGs
    (standin_jpegs) and seeded PNGs written with the port's PNG writer in
    turn RGB, grey, palette, palette with tRNS and grey+alpha at
    SPONZA_PNG_SIZES times size_scale; the MASK materials' base colours
    are RGBA PNGs with alphas of 0, 255 and between. Returns the .gltf
    path and a summary dict."""
    import numpy as np

    from vkr_tpu_torch.core.readback import png_bytes, png_chunk

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "Sponza", "glTF")
    os.makedirs(base, exist_ok=True)
    n = SPONZA_IMAGES
    # textures: albedo of every material but SPONZA_NO_ALBEDO, then MR of
    # every material but SPONZA_NO_MR, then a normal map of each
    albedo, mr, normal, t = {}, {}, {}, 0
    for table, skip in ((albedo, SPONZA_NO_ALBEDO), (mr, SPONZA_NO_MR),
                        (normal, ())):
        for m in range(SPONZA_MATERIALS):
            if m not in skip:
                table[m] = t
                t += 1
    assert t == n, t
    jpegs = standin_jpegs()
    # image kinds: the MASK albedo images are RGBA PNGs, the JPEGs spread
    # over the rest
    rgba_images = list(range(len(SPONZA_MASKS)))
    rest = rng.permutation(np.arange(len(SPONZA_MASKS), n)).tolist()
    jpeg_images = dict(zip(sorted(rest[:len(jpegs)]), jpegs))
    # texture -> image: the MASK albedos onto the RGBA images, the others
    # a derangement of the remaining images
    source = {albedo[m]: rgba_images[i] for i, m in enumerate(SPONZA_MASKS)}
    free_t = [t for t in range(n) if t not in source]
    free_i = [i for i in range(n) if i not in rgba_images]
    while True:
        perm = rng.permutation(free_i)
        if all(int(i) != t for t, i in zip(free_t, perm)):
            break
    source.update({t: int(i) for t, i in zip(free_t, perm)})
    assert all(source[t] != t for t in range(n))

    images, kinds, file_bytes = [], {}, 0
    png_i = 0
    for i in range(n):
        if i in jpeg_images:
            name, form = jpeg_images[i]
            with open(os.path.join(JPEG_DIR, name), "rb") as f:
                data = f.read()
            uri, kind = f"standin_{i:02d}.jpg", f"JPEG {name}: {form}"
        else:
            h, w = SPONZA_PNG_SIZES[png_i % len(SPONZA_PNG_SIZES)]
            h = max(1, round(h * size_scale))
            w = max(1, round(w * size_scale))
            if i in rgba_images:
                ctype, label = 6, "RGBA, partial alpha"
                px = _standin_pixels(rng, h, w, 4)
                a = px[..., 3].astype(np.int16)
                px[..., 3] = np.clip(3 * (a - 128) + 128, 0, 255)
            else:
                ctype, label = SPONZA_PNG_FORMS[
                    png_i % len(SPONZA_PNG_FORMS)]
                px = _standin_pixels(rng, h, w, {2: 3, 0: 1, 3: 1,
                                                 4: 2}[ctype])
            extra = b""
            if ctype == 3:
                px = px // 16
                extra = png_chunk(b"PLTE", rng.integers(
                    0, 256, 48, np.uint8).tobytes())
                if "tRNS" in label:
                    extra += png_chunk(b"tRNS", rng.integers(
                        0, 256, 16, np.uint8).tobytes())
            data = png_bytes(px, colour_type=ctype, filters=GLTF_FILTERS,
                             extra=extra, level=1)
            uri, kind = f"standin_{i:02d}.png", f"PNG {label} {w}x{h}"
            png_i += 1
        with open(os.path.join(base, uri), "wb") as f:
            f.write(data)
        file_bytes += len(data)
        images.append({"uri": uri})
        kinds[i] = kind

    materials = []
    for m in range(SPONZA_MATERIALS):
        pbr = {"metallicFactor": 0.0}
        if m in albedo:
            pbr["baseColorTexture"] = {"index": albedo[m]}
        if m in mr:
            pbr["metallicRoughnessTexture"] = {"index": mr[m]}
        mat = {"name": f"standin_material_{m:02d}",
               "pbrMetallicRoughness": pbr,
               "normalTexture": {"index": normal[m]}}
        if m in SPONZA_MASKS:
            mat["alphaMode"] = "MASK"
            if SPONZA_MASKS[m] is not None:
                mat["alphaCutoff"] = SPONZA_MASKS[m]
        materials.append(mat)
    doc = {
        "asset": {"version": "2.0",
                  "generator": "chip_smoke.write_sponza_standin"},
        "scene": 0, "scenes": [{"nodes": []}], "nodes": [], "meshes": [],
        "materials": materials,
        "textures": [{"sampler": 0, "source": source[t]} for t in range(n)],
        "samplers": [{"magFilter": 9729, "minFilter": 9987,
                      "wrapS": 10497, "wrapT": 10497}],
        "images": images,
    }
    path = os.path.join(base, "Sponza.gltf")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path, {"kinds": kinds, "file_bytes": file_bytes,
                  "jpegs": len(jpeg_images), "pngs": n - len(jpeg_images)}


def sponza_phase(res, cfg, device, root):
    """bench.py's default workload, sponza_colonnade_scene(columns=24,
    tessellation=80, tex_size=1024), on the stand-in written into root
    (VKR_ASSETS set to it for the phase): every committed JPEG held to
    its digest of PIL's bytes, the scene's and upload seconds and the
    texture bytes on the card printed, SPONZA_FRAMES default frames with
    the main phase's checks and each frame's own launches. Returns (scene,
    outputs)."""
    import hashlib

    import numpy as np
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import gltf as gltf_mod
    from vkr_tpu_torch.scene import procedural as proc_mod

    phase_t0 = time.perf_counter()
    path, info = write_sponza_standin(root, seed=0)
    write_s = time.perf_counter() - phase_t0
    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    decoded = []
    saved = os.environ.get("VKR_ASSETS")
    os.environ["VKR_ASSETS"] = root
    try:
        t0 = time.perf_counter()
        with returns(gltf_mod, "_decode_image", decoded):
            scene_np = proc_mod.sponza_colonnade_scene(
                columns=SCENE["columns"], tessellation=SCENE["tessellation"],
                tex_size=SPONZA_TEX)
        build_s = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("VKR_ASSETS", None)
        else:
            os.environ["VKR_ASSETS"] = saved
    check(len(decoded) == SPONZA_IMAGES, f"sponza: {len(decoded)} images "
          f"decoded of {SPONZA_IMAGES}")
    for i, img in enumerate(decoded):
        kind = info["kinds"][i]
        if not kind.startswith("JPEG "):
            continue
        name = kind.split()[1].rstrip(":")
        want = digests[name]
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        check(list(img.shape) == want["shape"] and img.dtype == np.uint8
              and got == want["rgba_sha256"],
              f"sponza: {name} ({want['form']}) decoded to {img.shape} "
              f"{got}, not PIL's {want['rgba_sha256']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = upload_scene(scene_np, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tex = scene.tex
    tex_bytes = sum(t.numel() * t.element_size()
                    for t in (tex.texels, tex.level_off, tex.level_w,
                              tex.level_h, tex.wrap))
    n_tri = len(scene.tri_opaque_mat) + len(scene.tri_masked_mat)
    used = sorted(set(scene_np.tri_material.tolist()))
    sampled = sorted({int(t) for m in used for t in (
        scene_np.mat_albedo_tex[m], scene_np.mat_mr_tex[m]) if t >= 0})
    level0 = SPONZA_IMAGES * SPONZA_TEX * SPONZA_TEX * 4
    print(f"sponza ({CARD}): stand-in Sponza/glTF/Sponza.gltf, "
          f"{len(scene_np.mat_albedo_tex)} materials, {SPONZA_IMAGES} images "
          f"({info['pngs']} PNG, {info['jpegs']} JPEG; "
          f"{info['file_bytes']} bytes) written in {write_s:.3f} s; every "
          f"JPEG decoded to PIL's digest ({digests['made_with']}); "
          f"sponza_colonnade_scene {build_s:.3f} s; upload "
          f"{upload_s:.3f} s; {n_tri} triangles "
          f"({len(scene.tri_masked_mat)} alpha-MASK), {len(used)} materials "
          f"drawn sampling {len(sampled)} of the {SPONZA_IMAGES} textures "
          f"{sampled}; texture bytes on the card {tex_bytes} (level 0 "
          f"{level0}), {tex.n_levels} levels, pairs {tex.paired}")
    check(n_tri == SCENE_TRIANGLES
          and len(scene.tri_masked_mat) == SCENE_MASKED,
          f"sponza: {n_tri} triangles, {len(scene.tri_masked_mat)} masked")
    check(scene_np.tex_mips[0].shape == (SPONZA_IMAGES, SPONZA_TEX,
                                         SPONZA_TEX, 4)
          and len(scene_np.mat_albedo_tex) == SPONZA_MATERIALS
          and len(sampled) <= 12 and tex.paired,
          f"sponza: textures {scene_np.tex_mips[0].shape}, "
          f"{len(scene_np.mat_albedo_tex)} materials, {len(sampled)} "
          "textures sampled")

    hook = FrameLaunches()
    kernels.LAUNCHES.clear()
    outs = render(scene, res, cfg, device, SPONZA_FRAMES, on_frame=hook)
    launches = dict(kernels.LAUNCHES)
    check_frames(outs, launches, SPONZA_FRAMES, MIN_LAUNCHES_PER_FRAME,
                 "sponza")
    for i, per in enumerate(hook.per_frame):
        for name, n in MIN_LAUNCHES_PER_FRAME.items():
            check(per.get(name, 0) >= n, f"sponza frame {i}: {name} "
                  f"launched {per.get(name, 0)} times")
    print(f"sponza: {SPONZA_FRAMES} frames (RenderConfig(), SSR on, MIS "
          f"GTAO), coverage "
          f"{[round(float((o['depth'] < 1.0).float().mean()), 4) for o in outs]}"
          f", overflow 0, launches per frame {hook.per_frame}")
    print(f"sponza: phase {time.perf_counter() - phase_t0:.1f} s")
    return scene, outs


# (label, BENCH_* settings, VKR_ASSETS at the stand-in)
BENCH_RUNS = (
    ("sponza_tex (stand-in)", {"BENCH_SCENE": "sponza_tex"}, True),
    ("colonnade", {"BENCH_SCENE": "colonnade"}, False),
    ("colonnade, serial", {"BENCH_SCENE": "colonnade", "BENCH_PIPELINE": "0"},
     False),
    ("BENCH_FRAMES=1", {"BENCH_FRAMES": "1"}, False),
)
BENCH_TIMED = 15  # completion intervals of the default 16 frames
BENCH_TIMEOUT_S = 300
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_STATS = re.compile(r"^coverage: (\d\.\d{3})  frames: (\d+)  "
                         r"min/median/max ms: [\d./]+  p10/p90: [\d./]+  "
                         r"trimmed25: [\d.]+  merged double-flush pairs: "
                         r"\d+$", re.M)
BENCH_SEGMENTS = ("gbuffer(raster+tex)", "mid(hiz+ssr+gtao)",
                  "tail(shading+taa)")
BENCH_RANGE_ERROR = ("ERROR: BENCH_FRAMES=1 out of range [2, 18] (>18 exits "
                     "the hall enclosure; <2 has no timed frame)")


def bench_phase(sponza_root):
    """vkr_tpu_torch/tools/bench.py as a user runs it: `python -m
    vkr_tpu_torch.tools.bench` in a subprocess for each of BENCH_RUNS, at
    its defaults (1920x1080, 16 frames) with BENCH_BREAKDOWN=1. Fails
    unless every run but the last exits 0 with exactly bench.py's four
    keys on its last stdout line (vs_baseline = round(value / 16, 3)),
    its stats line (coverage >= 0.98 over 15 frames), the three breakdown
    lines and no 'breakdown failed' on stderr, and every kernel of the
    frame launched in each timed frame (the tool's launch line); and
    unless BENCH_FRAMES=1 exits 1 with bench.py's range error before any
    scene is built."""
    for label, settings, assets in BENCH_RUNS:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")
               and k not in ("VKR_PLATFORM", "VKR_ASSETS")}
        env.update(settings, BENCH_BREAKDOWN="1")
        if assets:
            env["VKR_ASSETS"] = sponza_root
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "vkr_tpu_torch.tools.bench"], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        err = run.stderr
        if label == "BENCH_FRAMES=1":
            check(run.returncode == 1 and BENCH_RANGE_ERROR in err
                  and "scene+LUTs" not in err and not run.stdout,
                  f"bench {label}: exit code {run.returncode}, stderr "
                  f"{err[-2000:]!r}")
            print(f"bench ({label}): exit code 1, bench.py's range error, "
                  f"no scene built, {wall_s:.1f} s")
            continue
        check(run.returncode == 0, f"bench {label}: exit code "
              f"{run.returncode}, stderr {err[-4000:]!r}")
        check(bool(run.stdout.strip()), f"bench {label}: no stdout")
        last = run.stdout.strip().splitlines()[-1]
        head = json.loads(last)
        check(set(head) == BENCH_KEYS
              and head["metric"] == "1080p_full_pipeline_frame_time"
              and head["unit"] == "ms" and 0 < head["value"] < math.inf
              and head["vs_baseline"] == round(head["value"] / 16, 3),
              f"bench {label}: last line {last!r}")
        stats = BENCH_STATS.search(err)
        check(stats is not None and float(stats.group(1)) >= MIN_COVERAGE
              and int(stats.group(2)) == BENCH_TIMED,
              f"bench {label}: stats line {stats and stats.group(0)!r}")
        lines = err.splitlines()
        segments = [ln for ln in lines if ln.startswith("breakdown ")]
        check("breakdown failed" not in err and all(
            any(ln.startswith(f"breakdown {s}: ") for ln in segments)
            for s in BENCH_SEGMENTS), f"bench {label}: breakdown {segments}")
        check("backend: cuda" in lines, f"bench {label}: not on the card")
        counted = [ln for ln in lines if ln.startswith(
            f"kernel launches in the {BENCH_TIMED} timed frames: ")]
        check(len(counted) == 1, f"bench {label}: no launch line")
        # "{...} (the capture's {...} per frame times 15 replays)"
        launches = ast.literal_eval(
            counted[0].split(": ", 1)[1].split(" (", 1)[0])
        for name, per_frame in MIN_LAUNCHES_PER_FRAME.items():
            check(launches.get(name, 0) >= per_frame * BENCH_TIMED,
                  f"bench {label}: {name} launched {launches.get(name, 0)} "
                  f"times in {BENCH_TIMED} frames")
        start = [ln for ln in lines
                 if ln.startswith(("scene+LUTs", "compile+first"))]
        print(f"bench ({label}; {CARD}): {last}; {stats.group(0)}; "
              f"{'; '.join(segments)}; {'; '.join(start)}; launches "
              f"{launches}; {wall_s:.1f} s wall")


TOOLS_FRAMES = 8
TOOLS_ORBIT = 0.01  # rad/frame: render --orbit
TOOLS_TEX = 512     # render of the glTF scene: --tex-size, uniform mode
VIEWER_FRAMES = 6
# what the viewer's client sends, step k while frame k waits: (description,
# the POSTed message)
VIEWER_INPUT = (("slider weight_ratio 2.5, temporal rays 4",
                 {"slider": {"weight_ratio": 2.5, "ssr_temporal_rays": 4}}),
                ("toggle 2 (SSR off)", {"toggle": "2"}),
                ("toggle j (jitter off)", {"toggle": "j"}),
                ("r (hot reload)", {"toggle": "r"}))


@contextlib.contextmanager
def eager_tools():
    """The tools' frames eager while the block runs: core/aot.py's
    cached_jit hands each fn back uncaptured."""
    from vkr_tpu_torch.core import aot

    saved = aot.cached_jit
    aot.cached_jit = lambda name, fn, example_args, **kw: fn
    try:
        yield
    finally:
        aot.cached_jit = saved


def _drive_viewer(port, device, eager=False):
    """viewer.main on this (the main) thread with --max-frames
    VIEWER_FRAMES at its default 960x544, and a client thread that sends
    VIEWER_INPUT over HTTP. Frame k, once it has read its input, waits at
    its camera_frame call (before the viewer's timer starts) until the
    client has sent step k, so step k reaches frame k + 1; then the client
    reads frame k's PNG. eager: the frames uncaptured (eager_tools).
    Returns a dict: per-frame ms, what each frame saw (its config, jitter
    and the Tuning tensors it was called with), the client's log, the
    frames at which a reload ran, the frames at which a capture ran with
    the bytes it added to the allocator's reserve, and each frame's PNG
    bytes."""
    import threading
    import urllib.request

    import torch

    from vkr_tpu_torch import frame as F
    from vkr_tpu_torch.core import aot, readback, registry
    from vkr_tpu_torch.tools import viewer

    base = f"http://127.0.0.1:{port}"
    arrived = [threading.Event() for _ in VIEWER_INPUT]
    sent = [threading.Event() for _ in VIEWER_INPUT]
    seen, client_log, reloads, errors = [], [], [], []
    captures, pngs = [], []
    saved = (F.camera_frame, aot.cached_jit, registry.reload,
             readback.png_bytes, aot.CapturedFrame._capture)

    def camera_frame(cfg, view, prev, i, dev, use_jitter=True):
        seen.append({"ssr": cfg.enable_ssr, "use_jitter": use_jitter})
        if i < len(sent):
            arrived[i].set()
            if not sent[i].wait(120):
                errors.append(f"frame {i}: the client sent nothing")
        return saved[0](cfg, view, prev, i, dev, use_jitter=use_jitter)

    def cached_jit(name, fn, example_args, **kw):
        frame = fn if eager else saved[1](name, fn, example_args, **kw)

        def call(*args):
            seen[-1]["tuning"] = [t.clone() for t in args[3]]
            return frame(*args)
        return call

    def capture(self, args):
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        out = saved[4](self, args)
        torch.cuda.synchronize()
        captures.append((len(seen) - 1,
                         torch.cuda.memory_reserved() - before))
        return out

    def reload(*args, **kw):
        reloads.append(len(seen))
        return saved[2](*args, **kw)

    def png_bytes(*args, **kw):
        pngs.append(saved[3](*args, **kw))
        return pngs[-1]

    def client():
        try:
            for k, (what, msg) in enumerate(VIEWER_INPUT):
                if not arrived[k].wait(600):
                    raise TimeoutError(f"frame {k} did not start")
                if k == 0:
                    page = urllib.request.urlopen(base + "/").read()
                    client_log.append(f"page {len(page)} bytes")
                urllib.request.urlopen(urllib.request.Request(
                    base + "/input", data=json.dumps(msg).encode(),
                    method="POST")).read()
                client_log.append(f"sent {what}")
                sent[k].set()
                r = urllib.request.urlopen(f"{base}/frame.png?since={k}")
                png = r.read()
                n = int(r.headers["X-Frame"])
                if n != k + 1 or png[:8] != b"\x89PNG\r\n\x1a\n":
                    raise ValueError(f"after frame {k}: frame {n}, "
                                     f"{len(png)} bytes")
                client_log.append(f"frame {n}: {len(png)} PNG bytes")
            stats = json.loads(urllib.request.urlopen(base + "/stats")
                               .read())
            client_log.append(f"stats frame {stats['frame']} "
                              f"{stats['ms']:.3f} ms ssr {stats['ssr']} "
                              f"jitter {stats['jitter']}")
        except Exception as e:  # the main thread reports it
            errors.append(f"client: {e!r}")
            for ev in sent:
                ev.set()

    (F.camera_frame, aot.cached_jit, registry.reload, readback.png_bytes,
     aot.CapturedFrame._capture) = (camera_frame, cached_jit, reload,
                                    png_bytes, capture)
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        ms = viewer.main(["--port", str(port), "--max-frames",
                          str(VIEWER_FRAMES)])
    finally:
        (F.camera_frame, aot.cached_jit, registry.reload,
         readback.png_bytes, aot.CapturedFrame._capture) = saved
        for ev in sent + arrived:
            ev.set()
    th.join(60)
    check(not errors and not th.is_alive(), f"viewer: {errors}")
    for f in seen:
        f["tuning"] = [t.item() for t in f["tuning"]]
    return {"ms": ms, "seen": seen, "client": client_log,
            "reloads": reloads, "captures": captures, "pngs": pngs}


# The viewer's forced overflow (F1): frames 0-1 look steeply up the hall
# (fewer bin pairs), frames 2.. at the preset's view, jitter off, with
# raster/setup.PAIR_HEADROOM at 1.0 for the run: frame 2's replay drops
# pairs and frame 3 captures anew
OVERFLOW_FRAMES = 6
OVERFLOW_DENSE_FROM = 2
OVERFLOW_HEADROOM = 1.0
# The viewer's capture bound (F2): the checkbox frame i flips for frame
# i + 1, so frames 0..9 see ten toggle combinations, more than
# viewer.MAX_CAPTURES
BOUND_FLIPS = ("ssr", "gtao", "taa", "ao_only", "mis", "two_dirs",
               "refl_only", "normalize", "accumulate")


def _viewer_run(device, frames, views=None, flips=(), headroom=None,
                keep_calls=False):
    """viewer.main on this thread at its defaults (960x544), --max-frames
    `frames`, no client. views(i) -> (view, prev view) replaces the fly
    camera's for frame i (jitter off); flips[i] toggles that checkbox for
    frame i + 1; headroom sets raster/setup.PAIR_HEADROOM for the run.
    Returns a dict: the BinOverflow errors the frames met, the captures
    (frame, the bytes the capture added to the allocator's reserve, with
    nothing emptied before it), the reserve before the first capture and
    after each frame, and with keep_calls
    every replayed call (frame, fn, argument clones, colour and state
    clones)."""
    import torch

    from vkr_tpu_torch import frame as F
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.raster import setup
    from vkr_tpu_torch.tools import viewer

    got = {"overflows": [], "captures": [], "reserved": [], "calls": []}
    at, states = [-1], []
    saved = (F.camera_frame, viewer.ViewerState, aot.CapturedFrame.__call__,
             aot.CapturedFrame._capture, setup.PAIR_HEADROOM)

    def camera_frame(cfg, view, prev, i, dev, use_jitter=True):
        if i > 0:
            torch.cuda.synchronize()
            got["reserved"].append(torch.cuda.memory_reserved())
        at[0] = i
        if i < len(flips):
            with states[0].lock:
                states[0].toggles[flips[i]] ^= True
        if views is not None:
            view, prev = views(i)
            use_jitter = False
        return saved[0](cfg, view, prev, i, dev, use_jitter=use_jitter)

    class Spy(saved[1]):
        def __init__(self):
            super().__init__()
            states.append(self)

    def call(self, *args):
        try:
            out = saved[2](self, *args)
        except aot.BinOverflow as err:
            got["overflows"].append((at[0], err))
            raise
        if keep_calls:
            # the scene as it is (nothing writes it), the rest cloned
            got["calls"].append((at[0], self.fn, (args[0],) + aot._map(
                args[1:], lambda t: t.clone() if isinstance(t, torch.Tensor)
                else t), out[0].clone(), aot._map(out[1], torch.clone),
                int(out[2]["overflow"])))
        return out

    def capture(self, args):
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        got.setdefault("reserved_before", before)
        out = saved[3](self, args)
        torch.cuda.synchronize()
        got["captures"].append((at[0], torch.cuda.memory_reserved()
                                - before))
        return out

    (F.camera_frame, viewer.ViewerState, aot.CapturedFrame.__call__,
     aot.CapturedFrame._capture) = camera_frame, Spy, call, capture
    if headroom is not None:
        setup.PAIR_HEADROOM = headroom
    try:
        got["ms"] = viewer.main(["--port", str(_free_port()),
                                 "--max-frames", str(frames)])
    finally:
        (F.camera_frame, viewer.ViewerState, aot.CapturedFrame.__call__,
         aot.CapturedFrame._capture, setup.PAIR_HEADROOM) = saved
    torch.cuda.synchronize()
    got["reserved"].append(torch.cuda.memory_reserved())
    return got


def overflow_views():
    """(sparse, dense) views of the forced overflows: from the colonnade
    preset's eye, steeply up the hall (few bin pairs) and at the preset's
    centre."""
    import numpy as np

    from vkr_tpu_torch.mathlib import look_at
    from vkr_tpu_torch.tools.render import SCENE_PRESETS

    preset = SCENE_PRESETS["colonnade"]
    eye = np.asarray(preset["eye"], np.float32)
    fwd = np.asarray(preset["center"], np.float32) - eye
    fwd[1] = 0.0
    fwd /= np.linalg.norm(fwd)
    sparse = look_at(eye, eye + np.float32([0.0, 1.0, 0.0]) + 0.1 * fwd,
                     (0, -1, 0))
    return sparse, look_at(eye, preset["center"], (0, -1, 0))


def viewer_captures_phase(device):
    """F1 and F2 on the card. A forced overflow: the viewer captures on a
    steep view up the hall with PAIR_HEADROOM 1.0, then moves to the
    preset's denser view; it must go on to its last frame, having
    captured anew once (at frame 3, after frame 2's replay dropped pairs),
    with every frame from the recapture on equal, colour and state bit for
    bit, to the eager frame on the same inputs. The bound: ten toggle
    combinations, more than viewer.MAX_CAPTURES; the allocator's reserve
    must stay within MAX_CAPTURES x the largest capture of the reserve
    before the first."""
    import torch

    from vkr_tpu_torch.core.aot import _flat
    from vkr_tpu_torch.tools import viewer

    sparse, dense = overflow_views()

    def views(i):
        def at(k):
            return sparse if k < OVERFLOW_DENSE_FROM else dense
        return at(i), at(max(i - 1, 0))

    t0 = time.perf_counter()
    got = _viewer_run(device, OVERFLOW_FRAMES, views=views,
                      headroom=OVERFLOW_HEADROOM, keep_calls=True)
    run_s = time.perf_counter() - t0
    again = OVERFLOW_DENSE_FROM + 1
    check(len(got["ms"]) == OVERFLOW_FRAMES,
          f"viewer, forced overflow: {len(got['ms'])} frames")
    check([f for f, _ in got["overflows"]] == [again]
          and [f for f, _ in got["captures"]] == [0, again],
          f"viewer, forced overflow: overflows at frames "
          f"{[(f, e.dropped) for f, e in got['overflows']]}, captures at "
          f"{[f for f, _ in got['captures']]}")
    dropped = [c[5] for c in got["calls"] if c[0] == OVERFLOW_DENSE_FROM]
    check(dropped and dropped[0] > 0, f"viewer, forced overflow: frame "
          f"{OVERFLOW_DENSE_FROM} dropped {dropped} pairs")
    after = [c for c in got["calls"] if c[0] >= again]
    check(len(after) == OVERFLOW_FRAMES - again and all(
        c[5] == 0 for c in after), "viewer, forced overflow: the frames "
          "after the recapture dropped pairs")
    for i, fn, args, color, state, _ in after:
        want_color, want_state, _ = fn(*args)
        torch.cuda.synchronize()
        check(torch.equal(color, want_color) and all(
            torch.equal(a, b) for a, b in zip(_flat(state),
                                              _flat(want_state))),
              f"viewer, forced overflow: frame {i} differs from the eager "
              f"frame on its inputs")
    err = got["overflows"][0][1]
    print(f"tools viewer, forced overflow (PAIR_HEADROOM "
          f"{OVERFLOW_HEADROOM}, steep view for frames 0-1, the preset's "
          f"from {OVERFLOW_DENSE_FROM}): frame {again} found call "
          f"{err.call}'s {err.dropped} dropped pairs and captured anew; "
          f"{OVERFLOW_FRAMES} frames, ms {[round(m, 3) for m in got['ms']]}"
          f", frames {again}..{OVERFLOW_FRAMES - 1} equal to the eager "
          f"frames bit for bit; {run_s:.1f} s")

    t0 = time.perf_counter()
    got = _viewer_run(device, len(BOUND_FLIPS) + 1, flips=BOUND_FLIPS)
    run_s = time.perf_counter() - t0
    sizes = [b for _, b in got["captures"]]
    check(len(sizes) == len(BOUND_FLIPS) + 1 > viewer.MAX_CAPTURES,
          f"viewer, capture bound: {len(sizes)} captures")
    held = max(got["reserved"]) - got["reserved_before"]
    limit = viewer.MAX_CAPTURES * max(sizes)
    check(held <= limit, f"viewer, capture bound: {held} bytes reserved "
          f"over {len(sizes)} toggle combinations, more than "
          f"{viewer.MAX_CAPTURES} x the largest capture ({limit})")
    print(f"tools viewer, capture bound: {len(sizes)} toggle combinations, "
          f"MAX_CAPTURES {viewer.MAX_CAPTURES}; bytes each capture added "
          f"{sizes}; reserve above the first capture's start after each "
          f"frame {[r - got['reserved_before'] for r in got['reserved']]}, "
          f"at most {held} <= {viewer.MAX_CAPTURES} x {max(sizes)} = "
          f"{limit}; {run_s:.1f} s on {CARD}")


PROFILE_REPS = 8
# what profile's ten passes launch (K1 in gbuffer, the march in ssr_trace,
# K4 in gtao_window, K5 and R2 in ssr_blur, K5 in gtao_accum, K6 in taa)
# and entry()'s frame, by wrapper
SLICE_KERNELS = ("gbuf_tiles", "hierarchical_march",
                   "window_gather_bilinear_multi", "window_gather_bilinear",
                   "taa_history_gather", "ssr_blur")


def profile_phase(size, device, sponza_root):
    """tools/profile.py at 1080p as a user runs it (each pass captured
    through cached_jit, --reps PROFILE_REPS replays) and again eagerly
    (eager_tools); then its ten passes (profile.run_passes) each through
    a capture against fn on the same inputs: both of the capture's
    graphs' outputs bit-equal to the eager pass's, and the captures
    together launch every kernel of SLICE_KERNELS. Prints each pass's
    captured and eager ms, its capture seconds and launches, and the
    allocator's reserve with the ten captures alive. Then --scene sponza
    on the Sponza phase's stand-in."""
    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.tools import profile

    t_phase = time.perf_counter()
    argv = [*size, "--reps", str(PROFILE_REPS)]
    times = {}
    for mode in ("captured", "eager"):
        with (eager_tools() if mode == "eager"
              else contextlib.nullcontext()):
            times[mode] = profile.main(argv)
        torch.cuda.empty_cache()  # the dropped captures' pools
        check(tuple(times[mode]) == profile.PASSES
              and all(t > 0 for t in times[mode].values()),
              f"profile ({mode}): {times[mode]}")

    frames, reserved = [], torch.cuda.memory_reserved()

    def held(name, fn, args):
        want = [t.clone() for t in aot._flat(fn(*args))
                if isinstance(t, torch.Tensor)]
        frame = aot.cached_jit(name, fn, args)
        check(isinstance(frame, aot.CapturedFrame),
              f"profile {name}: cached_jit did not capture the pass")
        frames.append(frame)
        for g in range(2):  # the capture's call replays graph 0, then 1
            out = frame(*args)
            torch.cuda.synchronize()
            got = [t for t in aot._flat(out) if isinstance(t, torch.Tensor)]
            check(len(got) == len(want) > 0 and all(
                same_bits(a, b) for a, b in zip(got, want)),
                f"profile {name}: graph {g}'s outputs differ from the "
                f"eager pass's")
        return out

    profile.run_passes(profile.parse_args(argv), device, held)
    reserve = torch.cuda.memory_reserved() - reserved
    launched = collections.Counter()
    for frame in frames:
        launched.update(frame.launches)
    check(all(launched[k] >= 1 for k in SLICE_KERNELS),
          f"profile: the ten captures launch {dict(launched)}, not each of "
          f"{SLICE_KERNELS}")
    for frame in frames:
        print(f"tools profile {frame.name}: captured "
              f"{times['captured'][frame.name]:.3f} ms, eager "
              f"{times['eager'][frame.name]:.3f} ms (means of "
              f"{PROFILE_REPS}), capture {frame.capture_seconds:.3f} s, "
              f"launches {frame.launches}, both graphs' outputs equal to "
              f"the eager pass's bit for bit")
    print(f"tools profile at {size[1]}x{size[3]} on {CARD}: sums captured "
          f"{sum(times['captured'].values()):.3f} ms, eager "
          f"{sum(times['eager'].values()):.3f} ms; the ten captures "
          f"{sum(f.capture_seconds for f in frames):.3f} s and {reserve} "
          f"bytes of the allocator's reserve")
    del frames
    torch.cuda.empty_cache()

    saved = os.environ.get("VKR_ASSETS")
    os.environ["VKR_ASSETS"] = sponza_root
    try:
        t0 = time.perf_counter()
        kernels.LAUNCHES.clear()
        times = profile.main(["--scene", "sponza", *size, "--reps",
                              str(SPONZA_PROFILE_REPS)])
        sponza_s = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("VKR_ASSETS", None)
        else:
            os.environ["VKR_ASSETS"] = saved
    torch.cuda.empty_cache()
    # profile's G-buffer: an opaque and a masked K1 call in the warm-up
    # and in each of the two captures (a replay counts none)
    check(len(times) == 10 and all(t > 0 for t in times.values())
          and kernels.LAUNCHES.get("gbuf_tiles", 0) == 2 * 3,
          f"profile --scene sponza: {times}, launches "
          f"{dict(kernels.LAUNCHES)}")
    print(f"tools profile --scene sponza (--tex-size 512, the stand-in): "
          f"{sponza_s:.1f} s with the texture set's load, launches "
          f"{dict(kernels.LAUNCHES)}; profile phase "
          f"{time.perf_counter() - t_phase:.1f} s")


ENTRY_CALLS = 3
DRYRUN_RANKS = 4


def entry_phase():
    """vkr_tpu_torch/tools/entry.py, __graft_entry__.py's counterpart, on
    the card: entry()'s 128x128 frame captured by cached_jit (the state
    donated), ENTRY_CALLS calls equal to the eager fn's, run on clones of
    the same inputs, colour and every FrameState field bit for bit; the
    eager frames' exact bin-pair counts within the capture's capacities
    (fn returns no aux, so no replay reports an overflow: the same view
    bins the same pairs); one profiled replay running K1, the march, K4,
    K5 and K6 by CUDA symbol, as often as the capture recorded them. Then
    dryrun_multichip(DRYRUN_RANKS) on ranks sharing this card (gloo),
    its views and band frame captured by cached_jit: both of vkr_tpu's OK
    lines. Prints the capture seconds, a replay's
    device ms and the dry run's seconds."""
    import io

    import torch

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.raster import setup
    from vkr_tpu_torch.tools import entry as entry_mod

    t_phase = time.perf_counter()
    fn, args = entry_mod.entry()
    scene, state, cam = args
    check(cam.mvp.is_cuda and state.prev_depth.is_cuda,
          "entry(): the example arguments are not on the card")

    def tensors(color, st):
        return [color.clone()] + [getattr(st, f).clone() for f in st.FIELDS]

    st, eager, counts = aot._map(state, torch.clone), [], []
    for _ in range(ENTRY_CALLS):
        plan = setup.PairPlan()
        with setup.pair_plan(plan):
            color, st = fn(scene, st, cam)
        eager.append(tensors(color, st))
        counts.append(plan.counts)
    frame = aot.cached_jit("entry", fn, args, donate_argnums=(1,))
    check(isinstance(frame, aot.CapturedFrame),
          "entry: cached_jit did not capture entry()'s fn")
    st = state
    for i in range(ENTRY_CALLS):
        color, st = frame(scene, st, cam)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(tensors(color, st),
                                                     eager[i])),
              f"entry call {i}: the captured frame differs from the eager "
              f"fn")
    check(all(len(c) == len(frame.capacities)
              and all(n <= cap for n, cap in zip(c, frame.capacities))
              for c in counts),
          f"entry: pair counts {counts} beyond the capture's capacities "
          f"{frame.capacities}")
    check(all(frame.launches.get(k, 0) >= 1 for k in SLICE_KERNELS),
          f"entry: the capture launches {frame.launches}")
    symbols = {k: frame.launches.get(k, 0) for k in SLICE_KERNELS}
    device_ms, n_ops, seen, _ = profiled_replay(
        "entry", lambda: frame(scene, st, cam), symbols)
    entry_s = time.perf_counter() - t_phase
    print(f"entry: {ENTRY_CALLS} calls of entry()'s frame through "
          f"cached_jit equal the eager fn bit for bit (colour, FrameState); "
          f"pair counts {counts[0]} within capacities {frame.capacities}; "
          f"capture {frame.capture_seconds:.3f} s; a replay's device "
          f"{device_ms:.3f} ms in {n_ops} kernels and copies on {CARD}, "
          f"kernels by symbol {seen}; {entry_s:.1f} s")
    del frame, eager
    torch.cuda.empty_cache()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dry = entry_mod.dryrun_multichip(DRYRUN_RANKS)
    text = buf.getvalue()
    print(text, end="")
    for what in ("views OK", "bands OK"):
        check(f"dryrun_multichip({DRYRUN_RANKS}): {what}" in text,
              f"dryrun_multichip({DRYRUN_RANKS}) printed no '{what}'")
    print(f"entry: dryrun_multichip({DRYRUN_RANKS}) on ranks sharing "
          f"{CARD} (gloo): {dry['seconds']:.1f} s, coverage "
          f"{dry['coverage']:.4f}, max dev {dry['max_dev']:.3e}; entry "
          f"phase {time.perf_counter() - t_phase:.1f} s")


def tools_phase(gltf_path, tmp, device, sponza_root):
    """The user entry points (vkr_tpu_torch/tools) as a user calls them:
    render at 1080p through the kernels and as the oracle frame, render of
    the glTF phase's scene in uniform mode (the native asset pipeline),
    parity at 64 and 256, profile at 1080p (and --scene sponza on the
    Sponza phase's stand-in under sponza_root), scene_info, the viewer
    driven over HTTP and the showcase, each into the temporary directory
    tmp."""
    import io

    import torch

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.scene import gltf as gltf_mod
    from vkr_tpu_torch.scene import scene as scene_mod
    from vkr_tpu_torch.tools import parity, render, scene_info, showcase

    def decode(path):
        with open(path, "rb") as f:
            return gltf_mod.decode_png(f.read())[..., :3]

    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    outs = {}
    for label, extra in (("kernels", []), ("oracle", ["--no-kernels"])):
        out = os.path.join(tmp, f"render-{label}.png")
        kernels.LAUNCHES.clear()
        got = render.main(["--scene", "colonnade", *size, "--frames",
                           str(TOOLS_FRAMES), "--orbit", str(TOOLS_ORBIT),
                           "--out", out, *extra])
        launches = dict(kernels.LAUNCHES)
        img = decode(out)
        outs[label] = img
        check(img.shape == (HEIGHT, WIDTH, 3),
              f"render {label}: PNG shape {img.shape}")
        check(got["coverage"] >= MIN_COVERAGE,
              f"render {label}: coverage {got['coverage']}")
        # the frames are captured: a replay counts no launch, the capture
        # records each frame's (render.main's launches_per_frame)
        recorded = got["launches_per_frame"]
        check(recorded is not None, f"render {label}: the frame was not "
              "captured")
        if label == "kernels":
            for name, per_frame in MIN_LAUNCHES_PER_FRAME.items():
                check(recorded.get(name, 0) >= per_frame,
                      f"render: the captured frame launches {name} "
                      f"{recorded.get(name, 0)} times")
        else:
            check(not launches and not recorded,
                  f"render --no-kernels launched {launches}")
        print(f"tools render ({label}): {TOOLS_FRAMES} frames at "
              f"{WIDTH}x{HEIGHT}, orbit {TOOLS_ORBIT}, steady frame "
              f"{got['steady_ms']:.3f} ms (replays), coverage "
              f"{got['coverage']:.4f}, launches per captured frame "
              f"{recorded}")
    db = psnr(torch.from_numpy(outs["kernels"]).double() / 255.0,
              torch.from_numpy(outs["oracle"]).double() / 255.0)
    print(f"tools render: colour PNG, kernels vs --no-kernels (the oracle "
          f"frame): {db:.2f} dB")

    # the native asset pipeline: the glTF scene in uniform mode
    load_s = {}
    mips = {}
    for label, subs in (("library", {}), ("numpy plain version", {
            "build_mip_pyramid": scene_mod.build_mip_pyramid_plain,
            "_resize_rgba": scene_mod._resize_rgba_plain})):
        saved = {k: getattr(scene_mod, k) for k in subs}
        for k, fn in subs.items():
            setattr(scene_mod, k, fn)
        try:
            t0 = time.perf_counter()
            sc = scene_mod.load_scene(gltf_path, tex_size=TOOLS_TEX)
            load_s[label] = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(scene_mod, k, fn)
        mips[label] = sc.tex_mips
    check(all(a.shape == b.shape and bool((a == b).all()) for a, b in
              zip(mips["library"], mips["numpy plain version"])),
          "native asset pipeline: the library's mips differ from numpy's")
    print(f"tools load_scene (uniform, --tex-size {TOOLS_TEX}, "
          f"{len(mips['library'][0])} textures, {len(mips['library'])} "
          f"levels): library {load_s['library']:.3f} s, numpy plain version "
          f"{load_s['numpy plain version']:.3f} s, mips equal")
    out = os.path.join(tmp, "render-gltf.png")
    kernels.LAUNCHES.clear()
    got = render.main(["--scene", gltf_path, "--tex-size", str(TOOLS_TEX),
                       *size, "--frames", "2", "--out", out])
    check(decode(out).shape == (HEIGHT, WIDTH, 3)
          and (got["launches_per_frame"] or {}).get("gbuf_tiles", 0) >= 3,
          f"render of the glTF scene: launches per captured frame "
          f"{got['launches_per_frame']}")
    print(f"tools render (glTF, uniform {TOOLS_TEX}): steady frame "
          f"{got['steady_ms']:.3f} ms, coverage {got['coverage']:.4f}")

    # parity: each figure finite, at most PARITY_MAX_DROP_DB below the CPU;
    # the captured frames' report equal to the eager frames'
    for n in (64, 256):
        argv = ["--scene", "colonnade", "--size", str(n)]
        t0 = time.perf_counter()
        report = parity.main(argv)
        t1 = time.perf_counter()
        with eager_tools():
            eager = parity.main(argv)
        t2 = time.perf_counter()
        check(eager == report, f"parity --size {n}: the captured frames' "
              f"report {report} is not the eager frames' {eager}")
        print(f"tools parity --size {n}: captured frames (cached_jit) "
              f"{t1 - t0:.3f} s, eager {t2 - t1:.3f} s, reports equal")
        check(all(math.isfinite(v) for v in report.values()),
              f"parity --size {n}: {report}")
        if n == 64:
            for k, v in report.items():
                cpu = PARITY_64_CPU_DB[k]
                check(v >= cpu - PARITY_MAX_DROP_DB
                      or min(v, cpu) >= PARITY_HIGH_DB,
                      f"parity --size 64: {k} {v} dB on the card, {cpu} dB "
                      "pinned on the CPU")

    profile_phase(size, device, sponza_root)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(scene_info.main([gltf_path]) == 0, "scene_info failed")
    info = buf.getvalue()
    print(info, end="")
    check(f"compiled: {SCENE_TRIANGLES} triangles" in info,
          "scene_info: not the glTF phase's triangle count")

    runs = {mode: _drive_viewer(_free_port(), device, eager=eager)
            for mode, eager in (("captured", False), ("eager", True))}
    got = runs["captured"]
    seen, ms = got["seen"], got["ms"]
    print("tools viewer client: " + "; ".join(got["client"]))
    check(len(ms) == VIEWER_FRAMES, f"viewer rendered {len(ms)} frames")
    tun = [f["tuning"] for f in seen]
    check(tun[0] == [1.0, 1.0, 0.0, 1.0, 16] and tun[1][0] == 2.5
          and tun[1][4] == 4,
          f"viewer: the slider did not reach the next frame: {tun[:2]}")
    check(seen[1]["ssr"] and not seen[2]["ssr"],
          f"viewer: toggle 2 did not turn SSR off: {seen}")
    check(seen[2]["use_jitter"] and not seen[3]["use_jitter"],
          f"viewer: j did not turn the jitter off: {seen}")
    check(got["reloads"] == [4], f"viewer: r reloaded at frames "
          f"{got['reloads']}")
    # a capture for each toggle combination's first frame and after the
    # reload; the slider (frame 1) and j (frame 3) take none
    at = [f for f, _ in got["captures"]]
    check(at == [0, 2, 4] and not runs["eager"]["captures"],
          f"viewer: captures at frames {at}, eager "
          f"{runs['eager']['captures']}")
    check(got["pngs"] == runs["eager"]["pngs"]
          and len(got["pngs"]) == VIEWER_FRAMES,
          "viewer: the captured frames' PNGs differ from the eager frames'")
    replays = [m for i, m in enumerate(ms) if i not in at]
    eager_ms = runs["eager"]["ms"]
    print(f"tools viewer: {len(ms)} frames at 960x544 over HTTP, PNG bytes "
          f"equal to the eager frames'; captured ms/frame "
          f"{[round(m, 3) for m in ms]} (captures at frames {at}, "
          f"{[b for _, b in got['captures']]} bytes reserved by each), "
          f"median of the replays {statistics.median(replays):.3f} ms; "
          f"eager ms/frame {[round(m, 3) for m in eager_ms]}, median of "
          f"frames 1.. {statistics.median(eager_ms[1:]):.3f} ms")

    viewer_captures_phase(device)

    shows = {}
    for mode in ("captured", "eager"):
        out_dir = os.path.join(tmp, f"showcase-{mode}")
        t0 = time.perf_counter()
        with (eager_tools() if mode == "eager"
              else contextlib.nullcontext()):
            shown = showcase.main(["--out-dir", out_dir])
        files = []
        for path in (shown["gif"], shown["final"]):
            with open(path, "rb") as f:
                files.append(f.read())
        shows[mode] = (time.perf_counter() - t0, shown["render_s"], files)
    check(shows["captured"][2] == shows["eager"][2],
          "showcase: the captured frames' GIF or still differs from the "
          "eager frames'")
    show_s = shows["captured"][0]
    gif = shows["captured"][2][0]
    still = decode(shown["final"])
    check(gif[:6] == b"GIF89a" and gif[-1:] == b"\x3b"
          and still.shape == (HEIGHT, WIDTH, 3)
          and len(shown["frames"]) == 32
          and shown["frames"][0].shape == (HEIGHT // 3, WIDTH // 3, 3),
          f"showcase: GIF {len(gif)} bytes, still {still.shape}")
    print(f"tools showcase: {len(shown['frames'])} GIF frames of "
          f"{WIDTH // 3}x{HEIGHT // 3} ({len(gif)} bytes) and the "
          f"{WIDTH}x{HEIGHT} still, outside the repo, equal to the eager "
          f"frames' files; captured frames (cached_jit) {show_s:.3f} s, "
          f"{shows['captured'][1]:.3f} s of it the 72 frames; eager "
          f"{shows['eager'][0]:.3f} s, {shows['eager'][1]:.3f} s of it the "
          "frames")



def runtime_phase(scene, res, cfg, device, last):
    """Checkpoint the FrameState after frame CHECKPOINT_FRAME, resume the
    next frame from the file and hold it to the uninterrupted frame bit for
    bit; write the last main frame's colour as PNG and its depth as CSV
    and decode the PNG; time a cold and a warm LUT build through a
    temporary disk cache."""
    import tempfile

    import torch

    from vkr_tpu_torch.core import checkpoint, readback
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.scene.gltf import decode_png
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    def cam(i):
        return camera_frame(cfg, bench_orbit_view(i),
                            bench_orbit_view(max(i - 1, 0)), i, device)

    state = FrameState.initial(HEIGHT, WIDTH, device)
    for i in range(CHECKPOINT_FRAME + 1):
        _, state, _ = render_frame(scene, state, cam(i), res, cfg)
    nxt = CHECKPOINT_FRAME + 1
    color, after, _ = render_frame(scene, state, cam(nxt), res, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_state(state, os.path.join(tmp, "state.npz"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoint.load_state(path, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        color2, after2, _ = render_frame(scene, loaded, cam(nxt), res, cfg)
        check(torch.equal(color2, color), f"runtime: frame {nxt} resumed "
              "from the checkpoint differs from the uninterrupted frame")
        check(after2.frame_index == after.frame_index, "runtime: resumed "
              "frame_index differs")
        for name in FrameState.FIELDS[:-1]:
            check(torch.equal(getattr(after2, name), getattr(after, name)),
                  f"runtime: resumed FrameState.{name} differs")
        print(f"runtime: checkpoint after frame {CHECKPOINT_FRAME} "
              f"({ckpt_bytes} bytes) saved in {save_s:.3f} s, loaded on the "
              f"card in {load_s:.3f} s; frame {nxt} resumed from it equals "
              "the uninterrupted frame bit for bit (colour and FrameState)")

        t0 = time.perf_counter()
        png = readback.save_png(last["color"], os.path.join(tmp, "c.png"))
        png_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        csv = readback.save_depth_csv(last["depth"],
                                      os.path.join(tmp, "d.csv"))
        csv_s = time.perf_counter() - t0
        with open(png, "rb") as f:
            decoded = decode_png(f.read())[..., :3]
        pixels = readback.png_pixels(last["color"])
        check(decoded.shape == (HEIGHT, WIDTH, 3)
              and (decoded == pixels).all(), "runtime: the PNG does not "
              "decode to the pixels save_png computed")
        with open(csv) as f:
            rows = sum(1 for _ in f)
        check(rows == HEIGHT + 1, f"runtime: depth CSV has {rows} lines")
        print(f"runtime: save_png {os.path.getsize(png)} bytes in "
              f"{png_s:.3f} s (decodes to its pixels), save_depth_csv "
              f"{os.path.getsize(csv)} bytes in {csv_s:.3f} s")

        saved = os.environ.get("VKR_DISK_CACHE")
        os.environ["VKR_DISK_CACHE"] = os.path.join(tmp, "cache")
        try:
            times, built = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                built.append(build_ssr_resources(cfg.ssr.lut_size, device))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            if saved is None:
                del os.environ["VKR_DISK_CACHE"]
            else:
                os.environ["VKR_DISK_CACHE"] = saved
        check(all(torch.equal(a, b) for a, b in zip(*built)),
              "runtime: the warm LUTs differ from the cold ones")
        check(all(torch.equal(a, b) for a, b in zip(built[0], res)),
              "runtime: the disk-cached LUTs differ from the main phase's")
        print(f"runtime: build_ssr_resources({cfg.ssr.lut_size}) cold "
              f"{times[0]:.3f} s, warm {times[1]:.3f} s (disk cache), "
              "equal tensors")


def manifest_phase(cfg, device, f0, f1):
    """Every vkr_tpu manifest name resolves in the port; the passes that no
    frame calls run through registry.get on main frame 1's products at
    full width, each checked for vkr_tpu's shape and finite values."""
    import torch

    from vkr_tpu_torch.core import registry
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.mathlib.brdf import halton23_table
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.passes.sampling import (downsample_full_to_half,
                                               screen_uv_grid)
    from vkr_tpu_torch.passes.screen_trace import ScreenTraceParams
    from vkr_tpu_torch.passes.ssr import SSRParams, pack_pyramid
    from vkr_tpu_torch.passes.trace_samples import SamplesMarker
    from vkr_tpu_torch.passes.util_passes import DrawTex
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    missing = [n for n in MANIFEST_NAMES if n not in registry.names()]
    check(not missing, f"manifest: names not registered: {missing}")
    check(all(callable(registry.get(n)) for n in MANIFEST_NAMES),
          "manifest: a name does not resolve to a function")

    hiz = build_hiz(f1["depth"], f1["normal"], f1["velocity"])
    pyr = pack_pyramid(hiz.mips)
    hh, hw = hiz.mips[0].shape
    cam = camera_frame(cfg, bench_orbit_view(CAPTURE_FRAME),
                       bench_orbit_view(CAPTURE_FRAME - 1), CAPTURE_FRAME,
                       device)
    lens = (cfg.camera.fovy, cfg.aspect, cfg.camera.znear, cfg.camera.zfar)
    nm = _normal_mat4(cam.view)
    sp = SSRParams(nm, *lens, max_roughness=cfg.ssr.max_roughness)
    halton = torch.as_tensor(halton23_table(128), device=device)
    color_half = downsample_full_to_half(f1["color"])
    results = {}

    def run(label, name, *args, **kw):
        results[label] = registry.get(name)(*args, **kw)
        return results[label]

    def shaped(label, shape):
        out = results[label]
        check(tuple(out.shape) == shape and bool(torch.isfinite(
            out.float()).all()), f"manifest: {label} has shape "
            f"{tuple(out.shape)} (want {shape}) or is not finite")

    raw = run("screen_trace_main", "screen_trace_main", f1["depth"],
              f1["normal"], f1["color"], ScreenTraceParams(nm, *lens))
    filtered = run("screen_trace_filter", "screen_trace_filter",
                   f1["depth"], raw, cfg.camera.znear, cfg.camera.zfar)
    run("screen_trace_accumulate", "screen_trace_accumulate", f1["depth"],
        f0["depth"], filtered, torch.zeros_like(filtered), *lens)
    for label in ("screen_trace_main", "screen_trace_filter",
                  "screen_trace_accumulate"):
        shaped(label, (HEIGHT, WIDTH, 4))
    simple = run("ssr", "ssr", pyr, hiz.normal_half, color_half, sp)
    shaped("ssr", (hh, hw, 4))
    hits = float((simple[..., 3] > 0).float().mean())
    check(hits > MIN_SIMPLE_SSR_HITS, f"manifest: simple SSR hit in {hits} "
          "of the pixels")
    # the threshold at the median tile roughness, so both lists hold tiles
    glossy_value = float(registry.get("sssr_classification")(
        f1["material"], cfg.ssr.max_roughness, 0.0).avg_roughness.median())
    cls = run("sssr_classification", "sssr_classification", f1["material"],
              cfg.ssr.max_roughness, glossy_value)
    ty, tx = HEIGHT // 8, WIDTH // 8
    for field, shape in (("avg_roughness", (ty, tx)),
                         ("reflective_tiles", (ty * tx,)),
                         ("glossy_tiles", (ty * tx,))):
        out = getattr(cls, field)
        check(tuple(out.shape) == shape and bool(torch.isfinite(
            out.float()).all()), f"manifest: classification {field}")
    n_refl, n_glossy = int(cls.reflective_count), int(cls.glossy_count)
    check(n_refl + n_glossy == ty * tx and n_refl > 0 and n_glossy > 0,
          f"manifest: tile lists hold {n_refl} + {n_glossy} of "
          f"{ty * tx} tiles")
    # A tile whose normal equations are near singular (its 64 points lie
    # almost along one ray from the eye) gets a plane of ~1e19 and an
    # error that overflows float32 to +inf: vkr_tpu's function does the
    # same (2 tiles of a 1080p frame of the hall on the CPU). So the planes
    # must be finite, the errors finite or +inf, and +inf rare.
    fit = run("tile_regression", "tile_regression", f1["depth"],
              _inv4(cam.view), *lens)
    overflowed = int(torch.isinf(fit[..., 3]).sum())
    check(tuple(fit.shape) == (ty, tx, 4)
          and bool(torch.isfinite(fit[..., :3]).all())
          and not bool(torch.isnan(fit[..., 3]).any())
          and bool((fit[..., 3] >= 0).all())
          and overflowed <= MAX_REGRESSION_OVERFLOW * ty * tx,
          f"manifest: tile_regression shape {tuple(fit.shape)}, "
          f"{overflowed} tiles with an infinite error")
    # The classification of the full-res material: its 8x8 tiles cover the
    # half-res trace (a half-res grid has 67 tile rows, 536 of the 540
    # rows, and vkr_tpu's mask would not broadcast).
    for kind in (0, 1):
        label = f"sssr_trace_indirect (type {kind})"
        run(label, "sssr_trace_indirect", pyr, hiz.normal_half,
            f1["material"], sp, 1, halton, cls, reflection_type=kind)
        shaped(label, (hh, hw, 4))
    run("perlin", "perlin", HEIGHT, WIDTH, device=device)
    shaped("perlin", (HEIGHT, WIDTH))
    run("rotations", "rotations", HEIGHT, WIDTH, 0.3, device=device)
    shaped("rotations", (HEIGHT, WIDTH))
    run("texdraw", "texdraw", f1["material"], HEIGHT, WIDTH, DrawTex.ShowG)
    shaped("texdraw", (HEIGHT, WIDTH, 3))
    from vkr_tpu_torch.passes.util_passes import gen_mipmaps

    mips = gen_mipmaps(f1["color"])
    # one level per halving of the short side, down to one texel
    check(len(mips) == min(HEIGHT, WIDTH).bit_length()
          and min(mips[-1].shape[:2]) == 1
          and all(bool(torch.isfinite(m).all()) for m in mips),
          f"manifest: gen_mipmaps gave {len(mips)} levels")
    # the rays of an 8x8-pixel block at the centre of the half-res frame
    marker = SamplesMarker(hh, hw, (0.5, 0.5, 0.5 + 8 / hw, 0.5 + 8 / hh),
                           device=device)
    src = screen_uv_grid(hh, hw, device)
    heat = marker.trace(src, f1["ssr_rays"][..., :2])
    x0, y0, x1, y1 = marker.window
    in_window = int(((src[..., 0] >= x0) & (src[..., 0] <= x1)
                     & (src[..., 1] >= y0) & (src[..., 1] <= y1)).sum())
    check(heat.dtype == torch.int32 and tuple(heat.shape) == (hh, hw)
          and int(heat.sum()) == in_window > 0, f"manifest: the heatmap "
          f"counts {int(heat.sum())} fetches of {in_window} window rays")
    print(f"manifest: {len(MANIFEST_NAMES)} of vkr_tpu's names resolve "
          f"({len(registry.names())} registered); simple SSR hits "
          f"{hits:.4f} of the pixels; tiles {n_refl} reflective + "
          f"{n_glossy} glossy = {ty * tx} (glossy value "
          f"{glossy_value:.4f}); heatmap {int(heat.sum())} fetches of the "
          f"{in_window} rays in its window; tile_regression's error "
          f"overflowed on {overflowed} of {ty * tx} tiles")


# ---- multi-device phase: the band frame and view parallelism, ranks on
# one card through gloo
BAND_RANKS = 4
BAND_FRAMES = 3
# --multi-card: the band frames of the NCCL run
MULTI_CARD_FRAMES = 8
# host steps a graph of the band frame captured under gloo (its grouped
# gathers, parallel/band.py), one segment more
BAND_HOST_STEPS = 9
# the band frame's forced overflow (band_overflow): frames of it, with
# the viewer's views, headroom and frame of the denser view
BAND_OVERFLOW_FRAMES = 5
# the rank whose band calls (offset 270 rows, 135 at half res) are held
# against their plain versions
BAND_CAPTURE_RANK = 1
# vkr_tpu's bound for the band frame's colour and TAA history
# (tests/test_parallel.py:101-155)
BAND_COLOR_ATOL = 1e-6
RANK_TIMEOUT_S = 600
# the kernels every rank's band frame must launch, with their rows in the
# kernels line
BAND_ROWS = {name: f"{name} (band)" for name in (
    "gbuf_tiles", "hierarchical_march", "window_gather_bilinear_multi",
    "window_gather_bilinear", "taa_history_gather", "ssr_blur")}


def band_offset(name, args, kw):
    """A captured kernel call's band offset in rows: its row_offset or row0
    argument; for the march, which takes neither, its ray rows short of
    the screen's (nonzero only on a band)."""
    if name == "hierarchical_march":
        return args[0].heights[0] - args[1].shape[0]
    return kw.get("row_offset", 0) or kw.get("row0", 0)


def measure_call(name, args, kw, wrappers, plain):
    """A captured call through its kernel and its plain version on the
    card: (case for the kernels line, within tolerance, note, the plain
    version's result)."""
    import torch

    got = wrappers[name](*args, **kw)
    pkw = dict(kw, return_steps=True) if name == "hierarchical_march" \
        else kw
    want = plain[name][1](*args, **pkw)
    torch.cuda.synchronize()
    err, ok, note = compare(name, got, want, args, kw)
    nbytes, ops = work_of(name, args, kw, want)
    bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = ops / PEAK_F32_FLOPS * 1e3
    lib = library_call(name, args, kw)
    case = {"shape": shape_of(name, args, kw), "max_abs_err": err,
            "ms": time_ms(wrappers[name], args, kw),
            "plain_ms": time_ms(plain[name][1], args, kw),
            "library_ms": None if lib is None else time_ms(lib, (), {}),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "bytes": nbytes, "ops": ops}
    return case, ok, note, want


def _rank_setup(rank, n, port, backend):
    """A rank's process group (`backend` on tcp://localhost), its card
    (cuda:0 under gloo, where the ranks share it; cuda:rank under NCCL),
    and the main phase's scene, config and LUTs."""
    import torch
    import torch.distributed as dist

    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=n,
        rank=rank, **({"device_id": device} if backend == "nccl" else {}))
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    return (device, upload_scene(colonnade_scene(**SCENE), device), cfg,
            build_ssr_resources(cfg.ssr.lut_size, device))


def n_frames(backend):
    """Band frames a run renders: BAND_FRAMES on one card (gloo),
    MULTI_CARD_FRAMES over NCCL (--multi-card)."""
    return BAND_FRAMES if backend == "gloo" else MULTI_CARD_FRAMES


def _orbit_cam(cfg, i, device):
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    return camera_frame(cfg, bench_orbit_view(i),
                        bench_orbit_view(max(i - 1, 0)), i, device)


def band_rank(rank, n, port, tmp, backend):
    """One rank of the band frame: frames 0..n_frames(backend)-1 of the
    bench orbit, banded. Rank 0 writes each frame's G-buffer, colour and
    history to tmp; BAND_CAPTURE_RANK captures its kernel calls in frame
    CAPTURE_FRAME and holds them to their plain versions afterwards, and
    rasterises its band of the opaque layer through K7 against the whole
    frame's rows. Returns the rank's launches, peak memory and, from the
    capture rank, its cases."""
    import torch
    import torch.distributed as dist

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import render_frame_banded
    from vkr_tpu_torch.parallel.band import band_rows

    device, scene, cfg, res = _rank_setup(rank, n, port, backend)
    state = FrameState.initial(HEIGHT, WIDTH, device)
    captured, eager = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    kernels.LAUNCHES.clear()
    for i in range(n_frames(backend)):
        cam = _orbit_cam(cfg, i, device)
        capture = rank == BAND_CAPTURE_RANK and i == CAPTURE_FRAME
        with (Substitute(recording(captured)) if capture
              else contextlib.nullcontext()):
            color, state, aux = render_frame_banded(
                scene, state, cam, res, cfg, device=device)
        # on the host, out of the peak device memory the run prints
        eager.append(_frame_tensors(color, state, aux, "cpu"))
        if rank == 0:
            g = aux["gbuffer"]
            frame = {k: getattr(g, k).cpu() for k in FRAME_CHANNELS[:5]}
            frame.update(color=color.cpu(), taa_history=state.taa_history
                         .cpu(), prev_depth=state.prev_depth.cpu(),
                         overflow=int(aux["overflow"]))
            torch.save(frame, os.path.join(tmp, f"band{i}.pt"))
    out = {"launches": dict(kernels.LAUNCHES),
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "row0": band_rows(HEIGHT)[0]}
    out["captured"] = band_captured(scene, cfg, res, device, eager)
    del eager
    if backend == "gloo":
        out["overflow"] = band_overflow(scene, cfg, res, device)
    if rank == BAND_CAPTURE_RANK:
        plain = plain_versions()
        wrappers = {k: getattr(mod, k) for k, (mod, _) in plain.items()}
        cases = []
        for name, args, kw in captured:
            case, ok, note, _ = measure_call(name, args, kw, wrappers, plain)
            cases.append((name, band_offset(name, args, kw), case, ok, note))
        out["cases"] = cases
        out["k7"] = band_k7(scene, cfg, device, wrappers, plain)
    dist.barrier()
    dist.destroy_process_group()
    return out


def band_captured(scene, cfg, res, device, eager):
    """The band frame through core/aot.py:cached_jit, the state donated,
    on frames 0..len(eager)-1 of the bench orbit: each call's outputs
    (colour, FrameState, aux) bit-equal to this rank's eager band frame,
    overflow 0; then one replay under torch.profiler, which must run K1
    x3, the march, K4, K5 x3 and K6 by CUDA symbol, and the graph's nodes
    over its segments. Returns segments and host steps a graph, capture
    s, the profiled replay's device ms and kernels by symbol, graph nodes,
    the reserve and the part of it the capture added."""
    import torch
    import torch.distributed as dist

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import render_frame_banded

    def fn(s, st, c):
        return render_frame_banded(s, st, c, res, cfg, device=device)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    state = FrameState.initial(HEIGHT, WIDTH, device)
    frame = aot.cached_jit("band", fn, (scene, state,
                                        _orbit_cam(cfg, 0, device)),
                           donate_argnums=(1,))
    check(isinstance(frame, aot.CapturedFrame),
          "band: cached_jit did not capture the band frame")
    for i, want in enumerate(eager):
        color, state, aux = frame(scene, state, _orbit_cam(cfg, i, device))
        torch.cuda.synchronize()
        got = _frame_tensors(color, state, aux, "cpu")
        check(len(got) == len(want) and all(
            same_bits(a, b) for a, b in zip(got, want)),
            f"band frame {i}: the captured frame differs from the eager "
            "band frame")
        check(int(aux["overflow"]) == 0, f"captured band frame {i}: "
              f"overflow {int(aux['overflow'])}")
    reserved = torch.cuda.memory_reserved(device)
    symbols = {k: frame.launches.get(k, 0) for k in BAND_ROWS}
    check(all(symbols[k] >= MIN_LAUNCHES_PER_FRAME[k] for k in BAND_ROWS),
          f"band: the capture launches {frame.launches}")
    c = _orbit_cam(cfg, len(eager), device)
    dist.barrier()
    torch.cuda.synchronize()
    device_ms, n_ops, seen, _ = profiled_replay(
        "captured band frame", lambda: frame(scene, state, c), symbols)
    out = {"segments": frame.segments, "host_steps": frame.host_steps,
           "capture_s": frame.capture_seconds, "device_ms": device_ms,
           "ops": n_ops,
           "symbols": seen, "nodes": graph_nodes(frame),
           "reserved": reserved, "capture_bytes": reserved - before,
           "capacities": frame.capacities}
    del frame
    torch.cuda.empty_cache()
    return out


class RaiseLog:
    """A captured frame as aot.call_or_recapture sees it, keeping each
    BinOverflow it raised."""

    def __init__(self, frame):
        self.frame, self.donated, self.raised = frame, frame.donated, []

    def __call__(self, *args):
        from vkr_tpu_torch.core.aot import BinOverflow

        try:
            return self.frame(*args)
        except BinOverflow as err:
            self.raised.append(err)
            raise

    def cache_clear(self):
        self.frame.cache_clear()


def band_overflow(scene, cfg, res, device):
    """A forced overflow of the captured band frame (F1's, on every rank):
    with raster/setup.PAIR_HEADROOM at OVERFLOW_HEADROOM and the jitter
    off, frames 0-1 look steeply up the hall and the capture is made
    there; from
    OVERFLOW_DENSE_FROM on, the preset's denser view. The replay of frame
    OVERFLOW_DENSE_FROM drops pairs on some band, the summed overflow is
    every rank's, so every rank must raise BinOverflow at the next call
    and capture anew there (call_or_recapture), and from then on equal the
    eager band frame on the same inputs. Returns (frame, call, dropped)
    of each BinOverflow raised, the captures, the overflow per frame, the
    frames equal to eager."""
    import torch

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.parallel import render_frame_banded
    from vkr_tpu_torch.raster import setup

    def fn(s, st, c):
        return render_frame_banded(s, st, c, res, cfg, device=device)

    sparse, dense = overflow_views()

    def cam(i):  # jitter off, as the viewer's forced overflow
        def at(k):
            return sparse if k < OVERFLOW_DENSE_FROM else dense
        return camera_frame(cfg, at(i), at(max(i - 1, 0)), i, device,
                            use_jitter=False)

    again = OVERFLOW_DENSE_FROM + 1
    state = FrameState.initial(HEIGHT, WIDTH, device)
    raised, overflows, equal = [], [], []
    saved = setup.PAIR_HEADROOM
    setup.PAIR_HEADROOM = OVERFLOW_HEADROOM
    try:
        frame = RaiseLog(aot.cached_jit("band overflow", fn,
                                        (scene, state, cam(0)),
                                        donate_argnums=(1,)))
        for i in range(BAND_OVERFLOW_FRAMES):
            c = cam(i)
            carried = aot._map(state, torch.clone) if i >= again else None
            n_raised = len(frame.raised)
            color, state, aux = aot.call_or_recapture(frame, scene, state, c)
            raised += [(i, e.call, e.dropped)
                       for e in frame.raised[n_raised:]]
            overflows.append(int(aux["overflow"]))
            if carried is not None:
                want = fn(scene, carried, c)
                torch.cuda.synchronize()
                equal.append(all(same_bits(a, b) for a, b in zip(
                    _frame_tensors(color, state, aux),
                    _frame_tensors(*want))))
    finally:
        setup.PAIR_HEADROOM = saved
    captures = frame.frame.captures
    del frame
    torch.cuda.empty_cache()
    return {"raised": raised, "captures": captures, "overflows": overflows,
            "equal": equal}


def band_k7(scene, cfg, device, wrappers, plain):
    """The opaque layer of main frame CAPTURE_FRAME through K7 (the
    visibility-only raster, not on the band frame's path) at this rank's
    band viewport: (band rows equal to the whole frame's, the band call's
    case against its plain version)."""
    import torch

    from vkr_tpu_torch.parallel.band import band_rows
    from vkr_tpu_torch.raster.pipeline import rasterize
    from vkr_tpu_torch.raster.setup import corner_transform_t

    cam = _orbit_cam(cfg, CAPTURE_FRAME, device)
    corners = corner_transform_t(scene.corner_world_o, cam.mvp)
    row0, band_h = band_rows(HEIGHT)
    full = rasterize(corners, width=WIDTH, height=HEIGHT, jitter=cam.jitter)
    log = []
    with Substitute(recording(log)):
        band = rasterize(corners, width=WIDTH, height=band_h,
                         jitter=cam.jitter, full_height=HEIGHT,
                         y_offset=row0)
    torch.cuda.synchronize()
    equal = (torch.equal(band.depth, full.depth[row0:row0 + band_h])
             and torch.equal(band.tri_id, full.tri_id[row0:row0 + band_h]))
    name, args, kw = log[0]
    case, ok, note, _ = measure_call(name, args, kw, wrappers, plain)
    return equal, case, ok


def view_rank(rank, n, port, tmp, backend):
    """One rank of view parallelism: view `rank` of n orbit views
    (frame i sees orbit view i after view i-1, from a fresh FrameState).
    Rank 0 writes the gathered colours to tmp."""
    import torch
    import torch.distributed as dist

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import (batch_cams, batch_states,
                                        make_render_mesh,
                                        render_views_sharded)

    device, scene, cfg, res = _rank_setup(rank, n, port, backend)
    mesh = make_render_mesh(device=device)
    cams = batch_cams([_orbit_cam(cfg, v, device) for v in range(n)])
    states = batch_states(lambda: FrameState.initial(HEIGHT, WIDTH, device),
                          n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    kernels.LAUNCHES.clear()
    colors, new_states = render_views_sharded(scene, states, cams, res, cfg,
                                              mesh)
    torch.cuda.synchronize()
    out = {"launches": dict(kernels.LAUNCHES),
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "frame_index": new_states.frame_index.tolist()}
    if rank == 0:
        torch.save(colors.cpu(), os.path.join(tmp, "views.pt"))
    out["captured"] = views_captured(scene, cfg, res, mesh, cams, colors,
                                     new_states)
    dist.barrier()
    dist.destroy_process_group()
    return out


def views_captured(scene, cfg, res, mesh, cams, colors, new_states):
    """render_views_sharded through core/aot.py:cached_jit, the batched
    state donated: its first call (fresh states) bit-equal to the eager
    call's (colors, new_states), its second (on the first's states) to an
    eager call on the same states. Returns segments and host steps a
    graph, capture s, reserve."""
    import torch

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import batch_states, render_views_sharded

    def fn(s, st, c):
        return render_views_sharded(s, st, c, res, cfg, mesh)

    def fresh():
        return batch_states(
            lambda: FrameState.initial(HEIGHT, WIDTH, mesh.device),
            mesh.size)

    frame = aot.cached_jit("views", fn, (scene, fresh(), cams),
                           donate_argnums=(1,))
    check(isinstance(frame, aot.CapturedFrame),
          "views: cached_jit did not capture the views")
    got = frame(scene, fresh(), cams)
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(
        aot._flat(got), aot._flat((colors, new_states)))),
        "views: the first captured call differs from the eager call")
    want = aot._map(fn(scene, got[1], cams), torch.clone)
    got = frame(scene, got[1], cams)
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(aot._flat(got),
                                              aot._flat(want))),
          "views: the second captured call differs from the eager call")
    out = {"segments": frame.segments, "host_steps": frame.host_steps,
           "capture_s": frame.capture_seconds,
           "reserved": torch.cuda.memory_reserved(mesh.device)}
    del frame, got, want
    torch.cuda.empty_cache()
    return out


def nccl_rank(rank, n, port, tmp, backend):
    """One rank of the NCCL probe: an NCCL group of n ranks on cuda:0 and
    one all_reduce. NCCL refuses ranks that share a card, which is why the
    phase's ranks use gloo; the outcome is returned, not raised."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.destroy_process_group()
        return {"outcome": f"all_reduce gave {float(x)}"}
    except Exception as e:
        # the failed group is left to the process's exit: tearing down a
        # communicator that never formed is not needed
        lines = f"{type(e).__name__}: {e}".splitlines()
        return {"outcome": " / ".join(ln for ln in lines if ln.strip())}


def _rank_entry(job, rank, n, port, tmp, backend, q):
    """A spawned rank: run job and put (rank, result) on q; on an error,
    put the traceback and exit 1."""
    try:
        q.put((rank, job(rank, n, port, tmp, backend)))
    except BaseException:
        import traceback

        q.put((rank, {"error": traceback.format_exc()}))
        sys.exit(1)


def run_ranks(job, n, tmp, backend="gloo"):
    """Spawn n ranks of job (torch.multiprocessing, spawn), wait for each
    one's result, and stop them all. Fails if a rank raised, died or
    outlived RANK_TIMEOUT_S. Returns the results in rank order."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(job, r, n, port, tmp, backend, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(results) < n:
            try:
                rank, res = q.get(timeout=5)
                results[rank] = res
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                check(not dead, f"{job.__name__}: ranks {dead} died "
                      f"(exit codes {[procs[r].exitcode for r in dead]})")
                check(time.monotonic() < deadline, f"{job.__name__}: no "
                      f"result after {RANK_TIMEOUT_S} s from ranks "
                      f"{sorted(set(range(n)) - set(results))}")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(n):
        check("error" not in results[r], f"{job.__name__} rank {r} failed:"
              f"\n{results[r].get('error')}")
        check(procs[r].exitcode == 0, f"{job.__name__} rank {r} exited "
              f"{procs[r].exitcode}")
    return [results[r] for r in range(n)]


def multi_device_phase(scene, res, cfg, device, outs, backend="gloo",
                       n_ranks=BAND_RANKS):
    """The band frame (n_ranks ranks, n_frames(backend) frames) and view
    parallelism (n_ranks views). Under gloo every rank is a process on
    this card; under NCCL each rank has a card of its own (--multi-card).
    Holds the band frames to `outs`, the one-device frames 0..: G-buffer
    and prev_depth bit for bit, colour and TAA history within
    BAND_COLOR_ATOL; each view to that view's one-device frame. Every rank
    must launch each kernel of BAND_ROWS in every band frame. Returns
    (the capture rank's (kernel, offset, case, ok, note) band calls, the
    band run's launches summed over the ranks).

    Each rank then runs the band frame captured by cached_jit on the same
    frames (band_captured: under gloo BAND_HOST_STEPS host steps between
    graph segments, under NCCL one graph), each bit-equal to its eager
    band frame, and under gloo a forced overflow that every rank must
    capture anew from at the same call (band_overflow); each view rank
    runs the views captured (views_captured)."""
    import tempfile

    import torch

    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        if backend == "gloo":
            print("NCCL probe, 2 ranks on this one card: " + "; ".join(
                r["outcome"] for r in run_ranks(nccl_rank, 2, tmp)))
        ranks = run_ranks(band_rank, n_ranks, tmp, backend)
        for i in range(n_frames(backend)):
            band = torch.load(os.path.join(tmp, f"band{i}.pt"))
            ref = outs[i]
            for k in FRAME_CHANNELS[:5]:
                check(torch.equal(band[k].to(device), ref[k]),
                      f"band frame {i}: G-buffer {k} differs from the "
                      "one-device frame's")
            check(torch.equal(band["prev_depth"].to(device), ref["depth"]),
                  f"band frame {i}: prev_depth differs")
            check(band["overflow"] == 0, f"band frame {i}: overflow "
                  f"{band['overflow']}")
            color = band["color"].to(device)
            diffs = {k: float((band[k].to(device) - ref["color"]).abs()
                              .max()) for k in ("color", "taa_history")}
            same = float((color == ref["color"]).float().mean())
            print(f"band frame {i}: G-buffer and prev_depth equal to main "
                  f"frame {i} bit for bit; colour max |diff| "
                  f"{diffs['color']:.3g}, TAA history "
                  f"{diffs['taa_history']:.3g} (bit-equal pixels {same:.6f})")
            check(max(diffs.values()) <= BAND_COLOR_ATOL, f"band frame {i}: "
                  f"colour/history differ by {diffs} (> {BAND_COLOR_ATOL})")
        view_ranks = run_ranks(view_rank, n_ranks, tmp, backend)
        views = torch.load(os.path.join(tmp, "views.pt")).to(device)
    check(tuple(views.shape) == (n_ranks, HEIGHT, WIDTH, 3),
          f"views: shape {tuple(views.shape)}")
    view_diff = []
    for v in range(n_ranks):
        color, _, _ = render_frame(
            scene, FrameState.initial(HEIGHT, WIDTH, device),
            _orbit_cam(cfg, v, device), res, cfg)
        view_diff.append(float((views[v] - color).abs().max()))
    check(max(view_diff) <= BAND_COLOR_ATOL, f"views: max |diff| to the "
          f"one-device frames {view_diff}")
    check(all(r["frame_index"] == [1] * n_ranks for r in view_ranks),
          "views: the batched frame_index after one frame from fresh "
          "states")

    for r, out in enumerate(ranks):
        for name in BAND_ROWS:
            per_frame = MIN_LAUNCHES_PER_FRAME[name]
            got = out["launches"].get(name, 0)
            check(got >= per_frame * n_frames(backend), f"band rank {r}: "
                  f"{name} launched {got} times in {n_frames(backend)} "
                  "frames")
    for r, out in enumerate(view_ranks):
        check(all(out["launches"].get(k, 0) >= v for k, v in
                  MIN_LAUNCHES_PER_FRAME.items()),
              f"view rank {r}: launches {out['launches']}")
    steps = BAND_HOST_STEPS if backend == "gloo" else 0
    for r, out in enumerate(ranks):
        cap = out["captured"]
        check((cap["segments"], cap["host_steps"]) == (steps + 1, steps),
              f"band rank {r}: the captured band frame has "
              f"{cap['segments']} segments and {cap['host_steps']} host "
              f"steps a graph, not {steps + 1} and {steps}")
        print(f"band rank {r}, captured by cached_jit ({backend}): frames "
              f"0-{n_frames(backend) - 1} equal to this rank's eager band "
              f"frames bit for bit (colour, FrameState, aux), overflow 0; "
              f"{cap['segments']} segments and {cap['host_steps']} host "
              f"steps a graph, graph nodes {cap['nodes']}; capture "
              f"{cap['capture_s']:.3f} s (warm-up and two graphs); a "
              f"profiled replay's device {cap['device_ms']:.3f} ms in {cap['ops']} "
              f"kernels and copies, kernels by symbol {cap['symbols']}; "
              f"reserve {cap['reserved']} bytes ({cap['capture_bytes']} "
              f"added by the capture); bin-pair capacities "
              f"{cap['capacities']}")
    if backend == "gloo":
        again = OVERFLOW_DENSE_FROM + 1
        got = [out["overflow"] for out in ranks]
        calls = {tuple((i, call) for i, call, _ in o["raised"]) for o in got}
        check(len(calls) == 1 and len(got[0]["raised"]) == 1
              and got[0]["raised"][0][0] == again,
              f"band, forced overflow: BinOverflow raised (frame, call) "
              f"{[o['raised'] for o in got]}, not once at frame {again} "
              "on every rank")
        check(all(o["captures"] == 2 and o["equal"] == [True] * (
            BAND_OVERFLOW_FRAMES - again)
            and o["overflows"][OVERFLOW_DENSE_FROM] > 0
            and not any(o["overflows"][again:])
            for o in got), f"band, forced overflow: captures "
            f"{[o['captures'] for o in got]}, overflows "
            f"{[o['overflows'] for o in got]}, frames equal to eager "
            f"{[o['equal'] for o in got]}")
        print(f"band, forced overflow (PAIR_HEADROOM {OVERFLOW_HEADROOM}, "
              f"steep view for frames 0-1, the preset's from "
              f"{OVERFLOW_DENSE_FROM}): every rank raised BinOverflow at "
              f"frame {again} for call {got[0]['raised'][0][1]} "
              f"({got[0]['raised'][0][2]} pairs dropped over the bands) and "
              f"captured anew there; overflow per frame "
              f"{got[0]['overflows']}; frames {again}.."
              f"{BAND_OVERFLOW_FRAMES - 1} equal to the eager band frames "
              f"bit for bit on all {n_ranks} ranks")
    for r, out in enumerate(view_ranks):
        cap = out["captured"]
        check((cap["segments"], cap["host_steps"]) == (
            (2, 1) if backend == "gloo" else (1, 0)),
            f"view rank {r}: {cap['segments']} segments")
        print(f"view rank {r}, captured by cached_jit: two calls equal to "
              f"the eager calls bit for bit; {cap['segments']} segments; "
              f"capture {cap['capture_s']:.3f} s; reserve {cap['reserved']} "
              "bytes")
    for r, out in enumerate(ranks):
        last = out["row0"] + HEIGHT // n_ranks - 1
        print(f"band rank {r} (rows {out['row0']}..{last}): launches "
              f"{out['launches']}, peak device memory {out['peak_bytes']} "
              "bytes")
    print(f"views: {n_ranks} ranks, one orbit view each: max |diff| to "
          f"the one-device frames {view_diff}; peak device memory "
          f"{[o['peak_bytes'] for o in view_ranks]} bytes")

    equal, k7_case, k7_ok = ranks[BAND_CAPTURE_RANK]["k7"]
    print(f"kernel rasterize_tiles band [{k7_case['shape']}]: the band's "
          f"rows {'equal' if equal else 'DIFFER FROM'} the whole frame's; "
          f"max_abs_err {k7_case['max_abs_err']:.3g} against the plain "
          f"version ({'ok' if k7_ok else 'OUT OF TOLERANCE'}), "
          f"{k7_case['ms']:.4f} ms, plain {k7_case['plain_ms']:.4f} ms")
    check(equal and k7_ok, "band K7: the band raster differs")
    cases = ranks[BAND_CAPTURE_RANK]["cases"]
    failures = []
    for name, offset, case, ok, note in cases:
        lib = case["library_ms"]
        what = ("ray rows short of the screen's" if name ==
                "hierarchical_march" else "band offset")
        print(f"kernel {BAND_ROWS.get(name, name)} [{case['shape']}], "
              f"{what} {offset}: max_abs_err {case['max_abs_err']:.3g} "
              f"({'ok' if ok else 'OUT OF TOLERANCE'}"
              f"{', ' + note if note else ''}), {case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}: "
              f"{case['bytes'] / 1e6:.1f} MB, {case['ops'] / 1e9:.3f} GFLOP)")
        if not ok or offset == 0:
            failures.append(f"{name} offset {offset}: {case['max_abs_err']}")
    check(not failures, "band kernel calls: " + "; ".join(failures))
    check({c[0] for c in cases} >= set(BAND_ROWS), "band: rank "
          f"{BAND_CAPTURE_RANK} captured {sorted({c[0] for c in cases})}")
    launches = {}
    for out in ranks:
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return cases, launches


def multi_card_main() -> int:
    """`python3 chip_smoke.py --multi-card`, on a host with several cards:
    the multi-device phase over NCCL, one rank per card, against the
    one-device frames rendered on card 0 in the same run."""
    import torch

    if not cards():
        return 1
    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    n = torch.cuda.device_count()
    check(n >= 2, f"--multi-card needs at least 2 cards, found {n}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"build: {kernels.build():.2f} s")
    scene = upload_scene(colonnade_scene(**SCENE), device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    res = build_ssr_resources(cfg.ssr.lut_size, device)
    outs = render(scene, res, cfg, device, MULTI_CARD_FRAMES)
    _, launches = multi_device_phase(scene, res, cfg, device, outs,
                                     backend="nccl", n_ranks=n)
    print(f"band frame on {n} cards ({CARD}): launches summed over the "
          f"ranks {launches}")
    ok_line()
    return 0


def cards() -> bool:
    """False, with a message, without a CUDA card; else prints each card's
    name and power limit (nvidia-smi) and True."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return False
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    CARD = smi.stdout.strip()
    print(CARD)
    return True


def ok_line():
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    import torch

    if not cards():
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core.graph import PassGraph
    from vkr_tpu_torch.frame import build_probe_grid, build_ssr_resources
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.passes.shadows import render_shadow_map
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    build_s = kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    print(f"build: {build_s:.2f} s ({', '.join(kernels.SOURCES)})")
    from vkr_tpu_torch import native

    t0 = time.perf_counter()
    native_path = native.build()
    native.load()
    print(f"build: native asset pipeline {native_path.name}, "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in ("gbuf_tiles", "ssr_march"):
        for fn, (n, loops) in sass_loops(lib).items():
            print(f"sass {lib} {fn}: {n} instructions, loop bodies "
                  f"{loops[:6]}")

    t0 = time.perf_counter()
    scene_np = colonnade_scene(**SCENE)
    scene = upload_scene(scene_np, device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    check(cfg.enable_ssr and cfg.gtao.mis, "the main phase renders the "
          "default RenderConfig (SSR on, MIS GTAO)")
    res = build_ssr_resources(cfg.ssr.lut_size)
    check(res.pdf_lut.is_cuda and res.brdf_lut.is_cuda,
          "build_ssr_resources() did not put its LUTs on the card")
    lut_nonfinite = int((~torch.isfinite(res.pdf_lut)).sum())
    print(f"PDF LUT {cfg.ssr.lut_size}^2 on the card: {lut_nonfinite} "
          f"non-finite texels; BRDF LUT "
          f"{int((~torch.isfinite(res.brdf_lut)).sum())}")
    check(lut_nonfinite == 0, f"the PDF LUT has {lut_nonfinite} non-finite "
          "texels")
    torch.cuda.synchronize()
    n_tri = len(scene.tri_opaque_mat) + len(scene.tri_masked_mat)
    print(f"scene: {n_tri} triangles ({len(scene.tri_masked_mat)} "
          f"alpha-MASK), PDF and BRDF LUTs {cfg.ssr.lut_size}^2, "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_tri == SCENE_TRIANGLES and
          len(scene.tri_masked_mat) == SCENE_MASKED,
          f"scene has {n_tri} triangles, expected {SCENE_TRIANGLES}")

    # ---- main phase: the default frame, through the kernels; frame 1
    # under a pass graph ----
    captured = []
    graph = PassGraph()

    def capture(i):
        stack = contextlib.ExitStack()
        if i == CAPTURE_FRAME:
            stack.enter_context(Substitute(recording(captured)))
            stack.enter_context(graph.recording())
        return stack

    kernels.LAUNCHES.clear()
    outs = render(scene, res, cfg, device, N_FRAMES, on_frame=capture)
    launches = dict(kernels.LAUNCHES)
    check_frames(outs, launches, N_FRAMES, MIN_LAUNCHES_PER_FRAME, "main")
    chain = [r.name for r in graph.records]
    check(chain == MAIN_CHAIN, f"main frame {CAPTURE_FRAME}: the pass graph "
          f"recorded {chain}, not vkr_tpu's default chain {MAIN_CHAIN}")
    print(f"main frame {CAPTURE_FRAME} pass graph ({len(chain)} tasks, "
          "vkr_tpu's default chain):")
    print("\n".join(graph.dump().splitlines()[:10]))
    print(f"main: {N_FRAMES} frames at {WIDTH}x{HEIGHT} (SSR on, MIS "
          f"GTAO), coverage "
          f"{min(float((o['depth'] < 1.0).float().mean()) for o in outs):.4f}"
          f" (min), overflow 0, SSR max "
          f"{max(float(o['ssr'].max()) for o in outs):.4f}, launches "
          f"{launches}")

    # ---- traced phase: the frame as vkr_tpu runs it, captured and
    # replayed (core/aot.py:cached_jit), against the eager frame, on
    # bench.py's two scenes and this colonnade (the Sponza stand-in after
    # its phase; the SSR-off, probe and trilinear frames after theirs)
    traced = {"colonnade": traced_phase(
        "colonnade", scene, res, cfg, device, TRACED_FRAMES,
        MIN_LAUNCHES_PER_FRAME)}
    scene16 = upload_scene(colonnade_scene(**BENCH_COLONNADE), device)
    traced["16-column colonnade"] = traced_phase(
        "16-column colonnade", scene16, res, cfg, device, TRACED_FRAMES,
        MIN_LAUNCHES_PER_FRAME)
    del scene16

    # ---- SSR-off phase: the first slice's frame ----
    cfg_off = dataclasses.replace(cfg, enable_ssr=False)
    kernels.LAUNCHES.clear()
    off_outs = render(scene, res, cfg_off, device, SSR_OFF_FRAMES)
    off_launches = dict(kernels.LAUNCHES)
    check_frames(off_outs, off_launches, SSR_OFF_FRAMES,
                 SSR_OFF_MIN_LAUNCHES_PER_FRAME, "ssr-off")
    check("hierarchical_march" not in off_launches,
          "ssr-off: the march launched with SSR off")
    check("ssr_blur" not in off_launches,
          "ssr-off: R2 launched with SSR off")
    print(f"ssr-off: {SSR_OFF_FRAMES} frames, launches {off_launches}")
    traced["SSR off"] = traced_phase(
        "SSR off", scene, res, cfg_off, device, TRACED_OTHER_FRAMES,
        SSR_OFF_MIN_LAUNCHES_PER_FRAME)
    del off_outs

    # ---- shadow phase: K7 ----
    mvp = torch.as_tensor(light_view_proj(), device=device)
    kernels.LAUNCHES.clear()
    with Substitute(recording(captured)):
        shadow = render_shadow_map(scene, mvp, size=SHADOW_SIZE)
    shadow_launches = dict(kernels.LAUNCHES)
    check(shadow_launches.get("rasterize_tiles", 0) >= 1,
          f"shadow: rasterize_tiles launched "
          f"{shadow_launches.get('rasterize_tiles', 0)} times")
    shadow_cov = float((shadow < 1.0).float().mean())
    check(tuple(shadow.shape) == (SHADOW_SIZE, SHADOW_SIZE)
          and bool(torch.isfinite(shadow).all())
          and shadow_cov >= MIN_SHADOW_COVERAGE,
          f"shadow: shape {tuple(shadow.shape)}, coverage {shadow_cov:.4f}")
    print(f"shadow: {SHADOW_SIZE}^2 map, coverage {shadow_cov:.4f}, "
          f"launches {shadow_launches}")
    launches["rasterize_tiles"] = shadow_launches["rasterize_tiles"]

    # ---- probe phase: probe GI (BASELINE config 5) at start-up and per frame
    cfg_probe = dataclasses.replace(cfg, enable_probes=True)
    face_captured = []
    kernels.LAUNCHES.clear()
    with Substitute(recording(face_captured, limit=2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = build_probe_grid(scene_np, cfg_probe, device=device)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
    grid_launches = dict(kernels.LAUNCHES)
    n_faces = 6 * cfg_probe.probes.grid ** 2
    check(grid_launches.get("gbuf_tiles", 0) == 2 * n_faces,
          f"probe grid: gbuf_tiles launched {grid_launches} for {n_faces} "
          "faces (an opaque and a masked call each)")
    check(int(grid.face_overflow.max()) == 0,
          f"probe grid: bin pairs dropped on faces {grid.face_overflow}")
    check(bool(torch.isfinite(grid.colors).all()
               and torch.isfinite(grid.depth_flat).all()),
          "probe grid: not finite")
    print(f"probe grid: {cfg_probe.probes.grid}^2 probes, {n_faces} faces of "
          f"{cfg_probe.probes.cube_size}^2, octahedral "
          f"{cfg_probe.probes.oct_size}^2, start-up {grid_s:.3f} s, overflow "
          f"0 on every face, launches {grid_launches}")
    print("probe grid: covered share per face (+x, -x, +y, -y, +z, -z), "
          "probe by probe: " + "; ".join(
              " ".join(f"{c:.3f}" for c in row)
              for row in grid.face_coverage.tolist()))
    kernels.LAUNCHES.clear()
    probe_outs = render(scene, res, cfg_probe, device, PROBE_FRAMES,
                        probe_grid=grid)
    probe_launches = dict(kernels.LAUNCHES)
    check_frames(probe_outs, probe_launches, PROBE_FRAMES,
                 PROBE_MIN_LAUNCHES_PER_FRAME, "probe")
    filled = [o["probe_filled"] for o in probe_outs]
    check(min(filled) > 0.0, f"probe: probes filled {filled} of the pixels "
          "SSR left empty")
    print(f"probe: {PROBE_FRAMES} frames (SSR on, probes on), launches "
          f"{probe_launches}; share of SSR-empty pixels filled by a probe "
          f"hit per frame {[round(f, 4) for f in filled]}")
    traced["probe"] = traced_phase(
        "probe", scene, res, cfg_probe, device, TRACED_OTHER_FRAMES,
        PROBE_MIN_LAUNCHES_PER_FRAME, probe_grid=grid)

    # ---- RT phase: ray-traced GTAO over the scene grid
    from vkr_tpu_torch.frame import build_scene_tri_grid
    from vkr_tpu_torch.passes import gtao as gtao_mod

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri_grid = build_scene_tri_grid(scene_np, device=device, **RT_GRID)
    torch.cuda.synchronize()
    tri_grid_s = time.perf_counter() - t0
    kept_pairs = int((tri_grid.cell_tris >= 0).sum())
    all_pairs = kept_pairs + tri_grid.overflowed
    grid_bytes = sum(t.numel() * t.element_size() for t in (
        tri_grid.tri_verts, tri_grid.cell_tris, tri_grid.grid_min,
        tri_grid.cell_size))
    print(f"rt grid: build {tri_grid_s:.3f} s, dims {tri_grid.dims} "
          f"({math.prod(tri_grid.dims)} cells), cap {tri_grid.cap}, "
          f"{all_pairs} (triangle, cell) pairs, {tri_grid.overflowed} "
          f"dropped ({tri_grid.overflowed / all_pairs:.4f}), device bytes "
          f"{grid_bytes}")
    cfg_rt = dataclasses.replace(cfg, gtao=dataclasses.replace(
        cfg.gtao, use_ray_query=True))
    rt_captured = []

    def rt_hook(i):
        if i == CAPTURE_FRAME:  # R1's calls, for the kernel phase
            return Substitute(recording(rt_captured, only=("ray_any_hit",)))
        return contextlib.nullcontext()
    rt_frames = FrameLaunches(rt_hook)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    kernels.LAUNCHES.clear()
    rt_outs = render(scene, res, cfg_rt, device, RT_FRAMES, tri_grid=tri_grid,
                     on_frame=rt_frames)
    rt_launches = dict(kernels.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    check_frames(rt_outs, rt_launches, RT_FRAMES, RT_MIN_LAUNCHES_PER_FRAME,
                 "rt")
    check("window_gather_bilinear_multi" not in rt_launches,
          "rt: K4 launched: the MIS pass ran in place of gtao_rt")
    # gtao_rt runs R1 once per chunk of its directions: once a frame
    r1_per_frame = [per.get("ray_any_hit", 0) for per in rt_frames.per_frame]
    check(r1_per_frame == [RT_MIN_LAUNCHES_PER_FRAME["ray_any_hit"]]
          * RT_FRAMES, f"rt: R1 launched {r1_per_frame} times a frame")
    ao_diff = [float((o["ao"] - m["ao"]).abs().mean())
               for o, m in zip(rt_outs, outs)]
    check(min(ao_diff) > MIN_RT_AO_DIFF, f"rt: mean |AO - MIS AO| per frame "
          f"{ao_diff}: the ray-traced branch was not taken")
    print(f"rt: {RT_FRAMES} frames (SSR on, use_ray_query with the grid), "
          f"launches {rt_launches}; mean |AO - main phase's MIS AO| per "
          f"frame {[round(a, 4) for a in ao_diff]}; AO mean "
          f"{[round(float(o['ao'].mean()), 4) for o in rt_outs]}; peak "
          f"device memory {peak_bytes} bytes ({base_bytes} allocated before "
          f"the frames)")
    check(len(rt_captured) == RT_MIN_LAUNCHES_PER_FRAME["ray_any_hit"],
          f"rt: {len(rt_captured)} ray_any_hit calls recorded in frame "
          f"{CAPTURE_FRAME}")
    launches["ray_any_hit"] = rt_launches["ray_any_hit"]
    traced["RT"] = traced_phase(
        "RT", scene, res, cfg_rt, device, TRACED_OTHER_FRAMES,
        RT_MIN_LAUNCHES_PER_FRAME, tri_grid=tri_grid)

    # ---- variants phase: the other GTAO passes and SSAO at 1080p
    from vkr_tpu_torch.frame import _inv4, _normal_mat4, camera_frame
    from vkr_tpu_torch.mathlib.transforms import perspective
    from vkr_tpu_torch.passes import ssao as ssao_mod
    from vkr_tpu_torch.passes.downsample import build_hiz
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    f0, f1 = outs[CAPTURE_FRAME - 1], outs[CAPTURE_FRAME]
    hiz = build_hiz(f1["depth"], f1["normal"], f1["velocity"])
    prev_half = build_hiz(f0["depth"], f0["normal"], f0["velocity"]).mips[0]
    d_half, n_half = hiz.mips[0], hiz.normal_half
    cam1 = camera_frame(cfg, bench_orbit_view(CAPTURE_FRAME),
                        bench_orbit_view(CAPTURE_FRAME - 1), CAPTURE_FRAME,
                        device)
    lens = (cfg.camera.fovy, cfg.aspect, cfg.camera.znear, cfg.camera.zfar)
    gp = gtao_mod.GTAOParams(_normal_mat4(cam1.view), *lens)
    angle = gtao_mod.frame_base_angle(CAPTURE_FRAME)
    proj = torch.as_tensor(perspective(*lens), device=device)
    to_prev = proj @ cam1.prev_view @ _inv4(cam1.view)
    exact = gtao_mod.gtao_main_exact(d_half, n_half, gp, angle)
    reproject = (d_half, prev_half, exact, f0["ao"], to_prev, *lens)
    variants = [
        ("gtao_main_exact", gtao_mod.gtao_main_exact,
         (d_half, n_half, gp, angle), {}),
        ("gtao_main_dense", gtao_mod.gtao_main_dense,
         (d_half, n_half, gp, angle), {}),
        ("gtao_normal_space", gtao_mod.gtao_normal_space,
         (d_half, n_half, gp, angle), {}),
        ("gtao_main_deinterleaved", gtao_mod.gtao_main_deinterleaved,
         (d_half, n_half, gp, angle), {}),
        ("gtao_reproject (static)", gtao_mod.gtao_reproject, reproject, {}),
        ("gtao_reproject (matrix)", gtao_mod.gtao_reproject, reproject,
         {"matrix_mode": True}),
        ("ssao", ssao_mod.ssao,
         (f1["depth"], ssao_mod.SSAOParams(proj, *lens)), {}),
    ]
    for name, fn, args, kw in variants:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        check(tuple(out.shape) == tuple(args[0].shape)
              and bool(torch.isfinite(out).all()),
              f"variant {name}: shape {tuple(out.shape)} or not finite")
        print(f"variant {name} [{tuple(out.shape)}]: mean "
              f"{float(out.mean()):.4f}")
    # K4's pass against gtao_main_exact: to vkr_tpu's bound on vkr_tpu's
    # own kind of input, the close-range corner, at the half-res size; on
    # main frame 1 the far hall amplifies the taps' rounding (vkr_tpu's own
    # pair leaves both bounds there, tests/test_torch_gtao_variants.py), so
    # there the mean bound is held and the rest printed
    c_depth, c_normal, c_fields = corner_scene(*d_half.shape, device)
    for label, args, hold_max in (
            ("corner", (c_depth, c_normal, gtao_mod.GTAOParams(*c_fields),
                        angle), True),
            (f"main frame {CAPTURE_FRAME}", (d_half, n_half, gp, angle),
             False)):
        diff = (gtao_mod.gtao_main_window(*args)
                - gtao_mod.gtao_main_exact(*args)).abs()
        worst, mean = float(diff.max()), float(diff.mean())
        print(f"gtao_main_window (K4) vs gtao_main_exact, {label} at "
              f"{tuple(diff.shape)}: max {worst:.3g}, mean {mean:.3g}, "
              f"pixels over {WINDOW_EXACT_MAX:g} "
              f"{int((diff > WINDOW_EXACT_MAX).sum())}")
        check(mean < WINDOW_EXACT_MEAN
              and (worst < WINDOW_EXACT_MAX or not hold_max),
              f"gtao_main_window vs gtao_main_exact, {label}: max {worst}, "
              f"mean {mean}")
    del hiz, exact, diff, variants, reproject

    # ---- runtime phase: checkpoint and resume, PNG and depth CSV, the
    # disk-cached LUTs
    runtime_phase(scene, res, cfg, device, outs[N_FRAMES - 1])

    # ---- manifest phase: every name resolves; the passes no frame calls
    # run through the registry on main frame 1's products
    manifest_phase(cfg, device, outs[CAPTURE_FRAME - 1], outs[CAPTURE_FRAME])

    # ---- glTF phase: a glTF scene from disk, native-size textures,
    # trilinear sampling, the indexed front end
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    gltf_dir = os.path.join(scratch.name, "gltf")
    os.makedirs(gltf_dir)
    gltf_scene, cfg_gltf, gltf_outs, gltf_path = gltf_phase(
        cfg, res, device, gltf_dir)
    traced["glTF trilinear"] = traced_phase(
        "glTF trilinear", gltf_scene, res, cfg_gltf, device,
        TRACED_OTHER_FRAMES, MIN_LAUNCHES_PER_FRAME)

    # ---- JPEG glTF phase: the committed JPEG textures through the port's
    # decoder, the default frame on them; the AOT analog on the main frame
    jpeg_dir = os.path.join(scratch.name, "jpeg")
    os.makedirs(jpeg_dir)
    jpeg_scene, jpeg_outs = jpeg_gltf_phase(cfg, res, device, jpeg_dir)
    aot_s, n_aot = aot_check(scene, res, cfg, device)
    print(f"aot: main frame 0 through cached_jit ({aot_s:.3f} s) equals the "
          f"direct call bit for bit on all {n_aot} output tensors; PDF LUT "
          f"non-finite texels {lut_nonfinite}")

    # ---- Sponza phase: bench.py's default workload on the stand-in
    sponza_root = os.path.join(scratch.name, "assets")
    sponza_scene, sponza_outs = sponza_phase(res, cfg, device, sponza_root)
    traced["Sponza stand-in"] = traced_phase(
        "Sponza stand-in", sponza_scene, res, cfg, device, TRACED_FRAMES,
        MIN_LAUNCHES_PER_FRAME)
    # P10 on probe_orbit's frame, on the same stand-in
    p10_cases = p10_phase(device, sponza_root)
    print(f"traced phase: {sum(traced.values()):.1f} s over {list(traced)} "
          f"on {CARD}")

    # ---- bench phase: tools/bench.py as a user runs it, on the stand-in
    # and on the colonnade
    bench_phase(sponza_root)

    # ---- tools phase: the user entry points at full width
    tools_phase(gltf_path, scratch.name, device, sponza_root)
    scratch.cleanup()

    # ---- entry phase: __graft_entry__.py's entry points (tools/entry.py)
    entry_phase()

    # ---- multi-device phase: the band frame and view parallelism, ranks
    # on this card
    band_cases, band_launches = multi_device_phase(scene, res, cfg, device,
                                                   outs)

    # ---- kernel phase: the captured calls against the plain versions
    plain = plain_versions()
    wrappers = {name: getattr(mod, name) for name, (mod, _) in plain.items()}
    results = {}
    failures = []
    # (row of the kernels line, wrapper, args, kw): main frame 1's calls and
    # the shadow map's, then K1's opaque and masked calls on one probe face
    # and R1's 8 calls of RT frame 1
    calls = [(name, name, args, kw) for name, args, kw in captured] + [
        (PROBE_FACE_ROW, name, args, kw) for name, args, kw in face_captured]
    check([c[1] for c in calls[-2:]] == ["gbuf_tiles"] * 2,
          "probe grid: K1's calls on the first face were not captured")
    calls += [(name, name, args, kw) for name, args, kw in rt_captured]
    for row, name, args, kw in calls:
        case, ok, note, want = measure_call(name, args, kw, wrappers, plain)
        err, ms, plain_ms, library_ms = (case[k] for k in (
            "max_abs_err", "ms", "plain_ms", "library_ms"))
        nbytes, ops = case["bytes"], case["ops"]
        results.setdefault(row, []).append(case)
        if name == "hierarchical_march":
            steps = want[3]
            note += f", sum of iterations {int(steps.sum())}"
            print(f"march steps per ray: {quantiles(steps)}; at the cap "
                  f"{float((steps >= args[6]).double().mean()):.4f}")
            print(f"march SIMT efficiency (steps / 32 x warp longest): "
                  f"32x1 rays of a row (one ray per thread in raster order) "
                  f"{simt_efficiency(steps, 32, 1):.4f}, 8x4 patches (this "
                  f"kernel's mapping) {simt_efficiency(steps, 8, 4):.4f}, "
                  f"4x8 {simt_efficiency(steps, 4, 8):.4f}")
        if name in ("gbuf_tiles", "rasterize_tiles"):
            tile_px = kw["tile_h"] * kw["tile_w"]
            every = int(args[2].sum()) * tile_px
            kept, items = patch_survivors(*args[:3], kw)
            print(f"{name} [{case['shape']}]: pairs per tile "
                  f"{quantiles(args[2])}; the patch reject keeps {kept} of "
                  f"{items} (pair, 8x16 patch) items ({kept / items:.4f}): "
                  f"{kept * 128} pair-pixel tests, against "
                  f"{covered_pair_pixels(*args[:3], kw)} covered and {every} "
                  "in all")
        print(f"kernel {row} [{case['shape']}]: max_abs_err {err:.3g} "
              f"({'ok' if ok else 'OUT OF TOLERANCE'}{', ' + note if note else ''}"
              f"), {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
        if not ok:
            failures.append(f"{row} [{case['shape']}] max_abs_err {err}")
    # K1 and K7 on one tile of many chunks: ties and -0.0 depths
    for w, n_pairs, with_peel in STRESS:
        srows, sstart, scount = stress_rows(device, n_pairs, w, seed=w)
        skw = dict(width=w, height=8, tile_h=8, tile_w=w)
        for name in ("gbuf_tiles", "rasterize_tiles"):
            peel = with_peel and name == "gbuf_tiles"
            sargs = (srows, sstart, scount) + (
                (stress_peel(device, w, seed=w + 1),) if peel else ())
            got = wrappers[name](*sargs, **skw)
            want = plain[name][1](*sargs, **skw)
            torch.cuda.synchronize()
            err, ok, _ = compare(name, got, want, sargs)
            covered = float((want[1] >= 0).float().mean())
            label = (f"one 8x{w} tile, {n_pairs} pairs, equal and -0.0 "
                     f"depths{', peel floor' if peel else ''}")
            print(f"kernel {name} stress [{label}]: max_abs_err {err:.3g} "
                  f"({'ok' if ok else 'OUT OF TOLERANCE'}), covered "
                  f"{covered:.4f}, {time_ms(wrappers[name], sargs, skw):.4f}"
                  f" ms, plain {time_ms(plain[name][1], sargs, skw):.4f} ms")
            if not ok or covered < 0.5:
                failures.append(f"{name} stress [{label}]: max_abs_err "
                                f"{err}, covered {covered}")
    check(not failures, "kernel disagrees with its plain version: "
          + "; ".join(failures))
    # R1 beyond its row: t_max tensors, slot tests, lane maps, SASS
    r1_phase(rt_captured)
    # R2 on the benchmark's 1440p frame and one of its bands
    r2_phase(scene, res, device)
    # P10's row: probe_orbit's whole frame (p10_phase), its launches over
    # the probe phase's frames
    results["probe_trace"] = p10_cases[:1]
    launches["probe_trace"] = probe_launches["probe_trace"]
    for name in KERNELS:
        check(name in results, f"{name} was not called in main frame "
              f"{CAPTURE_FRAME}, the shadow phase, the probe grid or RT "
              f"frame {CAPTURE_FRAME}")
    del captured, face_captured, rt_captured

    # ---- the same frames through the plain versions ----
    kernels.LAUNCHES.clear()
    with Substitute(lambda name, wrapper, p: p):
        plain_outs = render(scene, res, cfg, device, N_FRAMES)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {}
    for i, (o, p) in enumerate(zip(outs, plain_outs)):
        for k in FRAME_CHANNELS:
            worst[k] = min(worst.get(k, math.inf), psnr(o[k], p[k]))
    print("psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"{k}: {v:.2f} dB against the plain "
              f"versions (< {MIN_PSNR_DB})")
    with Substitute(lambda name, wrapper, p: p):
        plain_probe = render(scene, res, cfg_probe, device, PROBE_FRAMES,
                                probe_grid=grid)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {k: min(psnr(o[k], p[k]) for o, p in zip(probe_outs, plain_probe))
             for k in FRAME_CHANNELS}
    print("probe psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"probe {k}: {v:.2f} dB against the plain "
              f"versions (< {MIN_PSNR_DB})")

    kernels.LAUNCHES.clear()
    with Substitute(lambda name, wrapper, p: p):
        plain_rt = render(scene, res, cfg_rt, device, RT_FRAMES,
                             tri_grid=tri_grid)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {k: min(psnr(o[k], p[k]) for o, p in zip(rt_outs, plain_rt))
             for k in FRAME_CHANNELS}
    print("rt psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"rt {k}: {v:.2f} dB against the plain "
              f"versions (< {MIN_PSNR_DB})")

    with Substitute(lambda name, wrapper, p: p):
        plain_gltf = render(gltf_scene, res, cfg_gltf, device,
                               GLTF_FRAMES)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {k: min(psnr(o[k], p[k]) for o, p in zip(gltf_outs, plain_gltf))
             for k in FRAME_CHANNELS}
    print("gltf psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"gltf {k}: {v:.2f} dB against the plain "
              f"versions (< {MIN_PSNR_DB})")

    with Substitute(lambda name, wrapper, p: p):
        plain_jpeg = render(jpeg_scene, res, cfg, device, JPEG_FRAMES)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {k: min(psnr(o[k], p[k]) for o, p in zip(jpeg_outs, plain_jpeg))
             for k in FRAME_CHANNELS}
    print("jpeg gltf psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"jpeg gltf {k}: {v:.2f} dB against the "
              f"plain versions (< {MIN_PSNR_DB})")

    with Substitute(lambda name, wrapper, p: p):
        plain_sponza = render(sponza_scene, res, cfg, device,
                                 SPONZA_FRAMES)
    check(sum(kernels.LAUNCHES.values()) == 0,
          "a kernel launched while the plain versions were substituted")
    worst = {k: min(psnr(o[k], p[k]) for o, p in zip(sponza_outs,
                                                     plain_sponza))
             for k in FRAME_CHANNELS}
    print("sponza psnr kernels vs plain versions (dB, min over frames): "
          + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= MIN_PSNR_DB, f"sponza {k}: {v:.2f} dB against the "
              f"plain versions (< {MIN_PSNR_DB})")

    launches[PROBE_FACE_ROW] = grid_launches["gbuf_tiles"]
    for name, row in BAND_ROWS.items():
        results[row] = [c[2] for c in band_cases if c[0] == name]
        launches[row] = band_launches.get(name, 0)
    table = []
    for name, (source, replaces) in list(KERNELS.items()) + [
            (row, KERNELS[name]) for name, row in BAND_ROWS.items()]:
        cases = results[name]

        def total(key):
            vals = [c[key] for c in cases]
            return None if None in vals else sum(vals)

        bound_by = max(cases, key=lambda c: c["bound_ms"])["bound_by"]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # per frame (per shadow map for K7, per probe face for K1 on
            # the faces, whose launches are per start-up): the sum over
            # its calls
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": bound_by,
            "library_ms": total("library_ms"),
        })
    print(json.dumps({"kernels": table}))
    ok_line()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(multi_card_main() if sys.argv[1:] == ["--multi-card"]
                 else main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
