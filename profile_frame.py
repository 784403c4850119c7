#!/usr/bin/env python3
"""Where the 1080p frame's time goes, on one CUDA card.

    python3 profile_frame.py

Renders chip_smoke.py's main workload (the bench orbit at 1920x1080 on the
314,988-triangle colonnade, the default RenderConfig: SSR on, MIS GTAO),
then the same with probe GI (enable_probes, the default 4x4 probe grid
built first), then with ray-traced GTAO (gtao.use_ray_query over the
scene grid of build_scene_tri_grid), and chip_smoke.py's glTF scene (the
colonnade written as glTF and loaded with native-size textures) with
trilinear_textures and without, right after the default frame; each three
times, N_FRAMES frames each, the first WARMUP_FRAMES of each unmeasured:

1. plain: host wall time per frame, bracketed by torch.cuda.synchronize().
2. per pass: a CUDA event pair and the host clock around each pass and each
   step of the raster front end. Prints stream ms and host ms per frame.
   Where stream ms equals host ms, the stream waits on the host's launches.
3. busy share: the measured frames run under torch.profiler with only CUDA
   activity recorded. The device time of every kernel and copy in those
   frames is divided by the host wall time of the same frames.
4. with probes: the kernels, copies and device ms of one probe_trace call
   on the last frame's inputs, under torch.profiler; with ray-traced GTAO
   the same for one gtao_rt call.
5. count read: plain frames as in 1, in runs that alternate between the
   exact bin-pair list (one host read of the pair count per raster call)
   and vkr_tpu's static capacity max(1.5 T, 4 n_tiles, 4096), which reads
   nothing; the median frame of each, so the read's host cost is measured
   in one process.

    python3 profile_frame.py default gltf_trilinear   # only these frames
    python3 profile_frame.py --root DIR default
    python3 profile_frame.py default --kernels-out kernels.tsv

--root profiles the vkr_tpu_torch package of another checkout at DIR
(an unpacked parent commit, say), so that two versions are compared in one
call on one card; a step that version lacks is not timed. The glTF frames
need this version's loader. --kernels-out appends every kernel and copy
of phase 3 (ms and launches per frame, name) to a file, so that two
versions' launch counts can be compared name by name.

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import os
import statistics
import subprocess
import sys
import time

from chip_smoke import HEIGHT, N_FRAMES, SCENE, WARMUP_FRAMES, WIDTH


def timed_steps():
    """(module, attribute, label) of every function timed in phase 2. The
    frame builds its passes through the registry, which resolves each name
    on its module when the frame runs, so a timer set on the pass's module
    reaches the frame (a checkout from before the registry calls the
    G-buffer pass through frame.py's own name for it)."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.passes import (downsample, gbuffer, gtao, probes,
                                      shading, ssr, ssr_march, taa)
    from vkr_tpu_torch.raster import gbuf_kernel, pair_rows, setup
    from vkr_tpu_torch.scene import accel
    try:
        from vkr_tpu_torch.passes import ssr_blur_kernel
    except ImportError:  # a checkout from before R2
        ssr_blur_kernel = None

    gbuffer_pass = frame if hasattr(frame, "render_gbuffer") else gbuffer
    return [step for step in [
        (gbuffer_pass, "render_gbuffer", "pass.gbuffer"),
        (downsample, "build_hiz", "pass.hiz"),
        (ssr, "ssr_trace", "pass.ssr_trace"),
        (ssr, "ssr_filter", "pass.ssr_filter"),
        (ssr, "ssr_blur", "pass.ssr_blur (R2, K5)"),
        (probes, "probe_trace", "pass.trace_probes"),
        (gtao, "gtao_main_mis", "pass.gtao_main_mis (K4)"),
        (gtao, "gtao_rt", "pass.gtao_rt"),
        (gtao, "gtao_filter", "pass.gtao_filter"),
        (gtao, "gtao_accumulate", "pass.gtao_accumulate (K5)"),
        (shading, "deferred_shading", "pass.shading"),
        (taa, "taa_resolve", "pass.taa (K6)"),
        (gbuffer, "rasterize", "gbuffer.rasterize"),
        (gbuffer, "_masked_alpha", "gbuffer.masked_alpha"),
        (gbuffer, "_lod_for", "gbuffer.lod"),
        (gbuffer, "sample_material_pair", "gbuffer.material_textures"),
        (setup, "clip_near_corners_t", "raster.clip_near"),
        (setup, "triangle_setup_t", "raster.triangle_setup"),
        (setup, "bin_triangles_t", "raster.bin_triangles"),
        (pair_rows, "build_tri_rows_t", "raster.build_tri_rows"),
        (pair_rows, "expand_pair_rows", "raster.expand_pair_rows"),
        (gbuf_kernel, "gbuf_tiles", "raster.gbuf_tiles (K1)"),
        (ssr_march, "hierarchical_march", "ssr.march (K2+K3)"),
        (accel, "ray_any_hit", "gtao_rt.ray_any_hit"),
        (ssr_blur_kernel, "ssr_blur", "ssr.blur (R2)"),
    ] if hasattr(step[0], step[1])]


@contextlib.contextmanager
def pass_timers(log):
    """Wrap every timed step; each call appends (label, start event, end
    event, host seconds) to log."""
    import torch

    saved = []

    def wrap(fn, label):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kw)
            end.record()
            log.append((label, start, end, time.perf_counter() - t0))
            return out
        return timed

    for mod, attr, label in timed_steps():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap(fn, label))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def frames(scene, res, cfg, device, measured, probe_grid=None,
           tri_grid=None):
    """Render the orbit; frames from WARMUP_FRAMES on run inside
    measured(). Returns the host seconds of each measured frame and of
    the measured frames as one block."""
    import torch

    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    state = FrameState.initial(HEIGHT, WIDTH, device)
    secs = []
    block = None
    ctx = contextlib.ExitStack()
    with ctx:
        for i in range(N_FRAMES):
            if i == WARMUP_FRAMES:
                ctx.enter_context(measured())
                torch.cuda.synchronize()
                block = time.perf_counter()
            cam = camera_frame(cfg, bench_orbit_view(i),
                               bench_orbit_view(max(i - 1, 0)), i, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, _ = render_frame(scene, state, cam, res, cfg,
                                       probe_grid=probe_grid,
                                       tri_grid=tri_grid)
            torch.cuda.synchronize()
            if i >= WARMUP_FRAMES:
                secs.append(time.perf_counter() - t0)
        block = time.perf_counter() - block  # before measured() exits
    return secs, block


FRAMES = ("default", "gltf_trilinear", "gltf_bilinear", "probe", "rt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("frames", nargs="*", metavar="FRAME",
                    help=f"frames to profile, of {', '.join(FRAMES)} "
                         "(default: all, in that order)")
    ap.add_argument("--root", help="checkout whose vkr_tpu_torch to profile")
    ap.add_argument("--kernels-out", metavar="FILE",
                    help="also write every kernel and copy of the busy-share "
                         "frames (ms and launches per frame, name) to FILE")
    args = ap.parse_args(argv)
    wanted = args.frames or list(FRAMES)
    unknown = sorted(set(wanted) - set(FRAMES))
    if unknown:
        ap.error(f"unknown frames {unknown}; choose from {FRAMES}")
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("profile_frame: torch.cuda.is_available() is False: this "
              "profile needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from vkr_tpu_torch import kernels
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import (build_probe_grid,
                                     build_scene_tri_grid,
                                     build_ssr_resources)
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    print(f"package: {os.path.dirname(os.path.abspath(kernels.__file__))}")
    kernels.build()
    scene_np = colonnade_scene(**SCENE)
    scene = upload_scene(scene_np, device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    res = build_ssr_resources(cfg.ssr.lut_size, device=device)
    cfg_probe = dataclasses.replace(cfg, enable_probes=True)
    cfg_rt = dataclasses.replace(cfg, gtao=dataclasses.replace(
        cfg.gtao, use_ray_query=True))
    cfg_tri = dataclasses.replace(cfg, trilinear_textures=True)
    grid = tri_grid = gltf_scene = None
    if "probe" in wanted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = build_probe_grid(scene_np, cfg_probe, device=device)
        torch.cuda.synchronize()
        print(f"probe grid: start-up {time.perf_counter() - t0:.3f} s")
    if "rt" in wanted:
        t0 = time.perf_counter()
        tri_grid = build_scene_tri_grid(scene_np, device=device)
        torch.cuda.synchronize()
        print(f"scene grid: start-up {time.perf_counter() - t0:.3f} s")
    if {"gltf_trilinear", "gltf_bilinear"} & set(wanted):
        gltf_scene = upload_scene(gltf_scene_np(), device)
    runs = {
        "default": ("default frame", scene, cfg, None, None),
        "gltf_trilinear": ("gltf frame (trilinear)", gltf_scene, cfg_tri,
                           None, None),
        "gltf_bilinear": ("gltf frame (bilinear)", gltf_scene, cfg, None,
                          None),
        "probe": ("probe frame", scene, cfg_probe, grid, None),
        "rt": ("rt frame", scene, cfg_rt, None, tri_grid)}
    for name in wanted:
        what, sc, c, g, tg = runs[name]
        print(f"==== {what}")
        profile(sc, res, c, device, g, tg, args.kernels_out)
    return 0


def gltf_scene_np():
    """chip_smoke.py's glTF scene: written to a temporary directory and
    loaded with native-size textures."""
    import tempfile

    from chip_smoke import gltf_textures, write_gltf
    from vkr_tpu_torch.scene.procedural import build_colonnade
    from vkr_tpu_torch.scene.scene import load_scene

    with tempfile.TemporaryDirectory() as tmp:
        src = build_colonnade(**SCENE)
        path = write_gltf(tmp, src, *gltf_textures(src.images))
        return load_scene(path, tex_size=SCENE["tex_size"],
                          native_sizes=True)


def profile(scene, res, cfg, device, grid, tri_grid, kernels_out=None):
    import torch

    from vkr_tpu_torch.passes import gtao, probes

    def run(measured):
        return frames(scene, res, cfg, device, measured, grid, tri_grid)

    n_measured = N_FRAMES - WARMUP_FRAMES
    label = f"frames {WARMUP_FRAMES}..{N_FRAMES - 1}"

    # ---- 1. plain frames ----
    secs, _ = run(contextlib.nullcontext)
    print(f"plain: median {statistics.median(secs) * 1e3:.3f} ms over "
          f"{label}; all {[round(s * 1e3, 3) for s in secs]}")

    # ---- 2. per pass ----
    log = []
    secs, _ = run(lambda: pass_timers(log))
    print(f"per pass: median frame {statistics.median(secs) * 1e3:.3f} ms "
          f"over {label} (with the timers); ms per frame:")
    stream, host = collections.Counter(), collections.Counter()
    calls = collections.Counter()
    for name, start, end, host_s in log:
        stream[name] += start.elapsed_time(end)
        host[name] += host_s * 1e3
        calls[name] += 1
    for mod, attr, name in timed_steps():
        print(f"  {name:28s} stream {stream[name] / n_measured:9.3f}  "
              f"host {host[name] / n_measured:9.3f}  "
              f"calls/frame {calls[name] / n_measured:g}")

    # ---- 3. busy share ----
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    secs, block = run(lambda: prof)
    device_ms, launches = device_time(prof)
    busy_ms = sum(device_ms.values())
    print(f"busy share: {label} under the profiler took {block * 1e3:.3f} "
          f"ms of host wall time (median frame "
          f"{statistics.median(secs) * 1e3:.3f} ms); device time "
          f"{busy_ms:.3f} ms in {sum(launches.values())} kernels and copies "
          f"({busy_ms / n_measured:.3f} ms and "
          f"{sum(launches.values()) / n_measured:.1f} per frame); busy "
          f"share {busy_ms / (block * 1e3):.4f}, idle share "
          f"{1 - busy_ms / (block * 1e3):.4f}")
    print("top device time (ms per frame, launches per frame):")
    for key, ms in device_ms.most_common(12):
        print(f"  {ms / n_measured:8.4f} {launches[key] / n_measured:7.1f}  "
              f"{key[:100]}")
    if kernels_out:
        with open(kernels_out, "a") as f:
            for key, ms in sorted(device_ms.items()):
                f.write(f"{ms / n_measured:.4f}\t"
                        f"{launches[key] / n_measured:.1f}\t{key}\n")

    # ---- 4. one probe trace or one gtao_rt call ----
    for on, mod, attr in ((grid is not None, probes, "probe_trace"),
                          (tri_grid is not None, gtao, "gtao_rt")):
        if on:
            one_call(mod, attr, run)

    # ---- 5. the pair-count read against a static capacity ----
    count_read(run, label)


def count_read(run, label, order="ESSE" * 5):
    """Plain frames with the exact bin-pair list (E) and with vkr_tpu's
    static capacity (S), the runs in `order`; prints each side's median
    frame, the median of the differences E - S between the runs' medians
    taken two by two (so the host's drift between runs cancels), and the
    pairs the static capacity dropped (a version whose raster passes a
    capacity itself runs the same frame both ways)."""
    from vkr_tpu_torch.raster import setup

    exact = setup.bin_triangles_t
    dropped = []

    def static(bbox, valid, width, height, tile_h, tile_w, pair_capacity):
        if pair_capacity is None:
            n_src = valid.shape[0] // 2  # clipping emits 2 rows per source
            n_tiles = -(-width // tile_w) * -(-height // tile_h)
            pair_capacity = max(int(n_src * 1.5), 4 * n_tiles, 4096)
        out = exact(bbox, valid, width, height, tile_h, tile_w,
                    pair_capacity)
        dropped.append(out[3])
        return out

    runs = []
    for side in order:
        setup.bin_triangles_t = static if side == "S" else exact
        try:
            runs.append((side, run(contextlib.nullcontext)[0]))
        finally:
            setup.bin_triangles_t = exact
    med = {k: statistics.median([t for s, ts in runs if s == k for t in ts])
           * 1e3 for k in "ES"}
    diffs = []
    for (s0, t0), (s1, t1) in zip(runs[::2], runs[1::2]):
        d = statistics.median(t0) - statistics.median(t1)
        diffs.append(round((d if s0 == "E" else -d) * 1e3, 3))
    print(f"count read: median frame {med['E']:.3f} ms exact, "
          f"{med['S']:.3f} ms static over {label} of {order.count('E')} "
          f"runs each, in the order {order}; exact - static, runs two by "
          f"two: median {statistics.median(diffs):.3f} ms, all {diffs}; "
          f"static capacity dropped {sum(int(d) for d in dropped)} pairs")


def one_call(mod, attr, run):
    """Kernels, copies and device ms of one mod.attr call on the last
    frame's inputs, under torch.profiler."""
    import torch

    fn = getattr(mod, attr)
    kept = []

    def keep(*a, **kw):
        kept.append((a, kw))
        return fn(*a, **kw)

    setattr(mod, attr, keep)
    try:
        run(contextlib.nullcontext)
    finally:
        setattr(mod, attr, fn)
    args, kw = kept[-1]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        fn(*args, **kw)
        torch.cuda.synchronize()
    device_ms, launches = device_time(p)
    print(f"{attr}: one call on the last frame's inputs, "
          f"{sum(launches.values())} kernels and copies, "
          f"{sum(device_ms.values()):.3f} device ms; top:")
    for key, ms in device_ms.most_common(6):
        print(f"  {ms:8.4f} {launches[key]:7d}  {key[:100]}")


def device_time(prof):
    """(device ms, launches) by kernel name of a finished profile."""
    device_ms = collections.Counter()
    launches = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            device_ms[e.key] += e.self_device_time_total / 1e3
            launches[e.key] += e.count
    return device_ms, launches


if __name__ == "__main__":
    sys.exit(main())
