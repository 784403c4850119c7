"""__graft_entry__.py's entry points on the port:
entry() gives one capturable 128x128 frame of the colonnade with its
example arguments, and dryrun_multichip(n) renders the sharded views and
the band frame on n rank processes of a gloo group.

vkr_tpu runs its dry run on n virtual XLA devices in one process; the
port starts n ranks (torch.multiprocessing, spawn) on tcp://localhost, on
the card (rank r on cuda:(r mod the visible cards), so ranks may share
one card) unless the caller asks for the CPU. Both functions pick their
device with core/platform.py:ensure_platform: without a card and without
platform="cpu" (or VKR_PLATFORM=cpu) they raise.

    python -m vkr_tpu_torch.tools.entry                 # on the card
    DRYRUN_DEVICES=4 python -m vkr_tpu_torch.tools.entry
    VKR_PLATFORM=cpu DRYRUN_DEVICES=2 python -m vkr_tpu_torch.tools.entry

The module run captures entry()'s frame with cached_jit, runs it once,
then runs dryrun_multichip(DRYRUN_DEVICES, default 8); it exits non-zero
on any failure. The dry run's views and band frame go through cached_jit,
as __graft_entry__.py jits them: on the card each rank captures them (the
gloo gathers as host steps between graph segments, core/aot.py); on the
CPU cached_jit returns the eager function.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import sys
import time

import numpy as np

DRYRUN_SIZE = 64
RANK_TIMEOUT_S = 600
MIN_COVERAGE = 0.05
# the band frame against one device (tests/test_torch_parallel.py:_hold):
# G-buffer and prev_depth bit for bit, colour and TAA history within this
BAND_ATOL = 1e-6
GBUF = ("albedo", "normal", "material", "velocity", "depth")
LOOK = dict(center=(4, 1.8, 0.5), up=(0, -1, 0))


def small_config(size: int = 128, ssr_iters: int = 16):
    """RenderConfig(width=size, height=size) with SSR's max_iterations
    ssr_iters (__graft_entry__.py:_small_cfg)."""
    from vkr_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=size, height=size)
    return dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=ssr_iters))


def scene_and_resources(device, tex_size: int = 64, lut_size: int = 64):
    """The 3-column colonnade (tessellation 8) uploaded to device and the
    SSR LUTs of lut_size there (__graft_entry__.py:_scene_and_resources)."""
    from vkr_tpu_torch.frame import build_ssr_resources
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import colonnade_scene

    scene = upload_scene(colonnade_scene(columns=3, tessellation=8,
                                         tex_size=tex_size), device)
    return scene, build_ssr_resources(lut_size, device=device)


def entry(platform=None):
    """(fn, example_args): one frame of the colonnade at 128x128 (raster,
    SSR, GTAO, shading, TAA through the kernels), fn(scene, state, cam) ->
    (colour, new FrameState), and its arguments on ensure_platform(
    platform)'s device. fn is capturable: cached_jit("entry", fn, args,
    donate_argnums=(1,)). It returns no aux, as vkr_tpu's does, so a
    capture of it reads no bin-pair overflow: its replays must keep to
    the capture's view (the example camera)."""
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.platform import ensure_platform
    from vkr_tpu_torch.frame import camera_frame, render_frame
    from vkr_tpu_torch.mathlib import look_at

    device = ensure_platform(platform)
    cfg = small_config()
    scene, ssr_res = scene_and_resources(device)
    state = FrameState.initial(cfg.height, cfg.width, device)
    view = look_at((-6, 2.2, -2), **LOOK)
    cam = camera_frame(cfg, view, view, 0, device)

    def fn(scene_in, state_in, cam_in):
        color, new_state, _aux = render_frame(scene_in, state_in, cam_in,
                                              ssr_res, cfg)
        return color, new_state

    return fn, (scene, state, cam)


def dryrun_multichip(n_devices: int, platform=None) -> dict:
    """n_devices ranks render, each on its device (see the module
    docstring), vkr_tpu's two checks at 64x64 (SSR max_iterations 8, the
    3-column colonnade with 32^2 textures, LUTs of 32):

    views: n orbit cameras around (4, 1.8, 0.5) through
    render_views_sharded over make_render_mesh(n), captured by cached_jit
    (the batched state donated): every output bit-equal to the eager
    call's; colours (n, 64, 64, 3), finite, more than MIN_COVERAGE of
    prev_depth below 1;
    bands: camera 0 through render_frame_banded, captured by cached_jit
    (the state donated): every output bit-equal to the eager band frame's,
    and against the rank's own one-device render_frame: G-buffer and
    prev_depth bit for bit, colour and TAA history within BAND_ATOL,
    overflow 0 (vkr_tpu allows 4e-3 between its two jitted programs; the
    port's captured frame replays the eager frame's kernels).

    Prints vkr_tpu's "views OK" and "bands OK" lines and returns
    {"coverage", "max_dev", "seconds"}. 64 rows must split into n bands of
    an even height (parallel/band.py:band_rows), else ValueError before
    any rank starts. A rank that raises, dies or outlives RANK_TIMEOUT_S
    makes this raise; every rank is stopped before it returns."""
    from vkr_tpu_torch.core.platform import ensure_platform

    n = int(n_devices)
    if n < 1 or DRYRUN_SIZE % (2 * n):
        raise ValueError(f"dryrun_multichip: {DRYRUN_SIZE} rows do not "
                         f"split into {n} bands of an even height")
    device = ensure_platform(platform)
    if device.type == "cuda":
        from vkr_tpu_torch import kernels

        kernels.build()  # once here, not raced by the ranks
    t0 = time.perf_counter()
    results = run_ranks(_dryrun_rank, n, device.type, RANK_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    first = results[0]
    print(f"dryrun_multichip({n}): views OK — colors "
          f"{first['colors_shape']}, coverage {first['coverage']:.3f}",
          flush=True)
    max_dev = max(r["max_dev"] for r in results)
    print(f"dryrun_multichip({n}): bands OK — {first['band_shape']} "
          f"matches single-device (max dev {max_dev:.2e})", flush=True)
    return {"coverage": first["coverage"], "max_dev": max_dev,
            "seconds": seconds}


def _orbit_cams(cfg, n, device):
    """vkr_tpu's dry-run cameras (__graft_entry__.py:94-103)."""
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.mathlib import look_at

    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([4 + 6 * np.cos(ang), 2.2, 0.5 + 4 * np.sin(ang)],
                       np.float32)
        view = look_at(eye, **LOOK)
        cams.append(camera_frame(cfg, view, view, i, device))
    return cams


def _fail(what: str):
    raise RuntimeError(f"dryrun_multichip: {what}")


def same_bits(a, b) -> bool:
    """Every tensor of two result trees equal bit for bit (NaNs too), the
    other leaves equal."""
    import torch

    from vkr_tpu_torch.core.aot import _flat

    def bits(t):
        if t.is_floating_point():
            return t.view({2: torch.int16, 4: torch.int32,
                           8: torch.int64}[t.element_size()])
        return t

    xs, ys = _flat(a), _flat(b)
    return len(xs) == len(ys) and all(
        (x.dtype == y.dtype and x.shape == y.shape
         and torch.equal(bits(x), bits(y)))
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(xs, ys))


def _dryrun_rank(rank: int, n: int, device) -> dict:
    """One rank's share of the dry run: both checks, raising on a miss."""
    import torch

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.parallel import (make_render_mesh,
                                        render_frame_banded,
                                        render_views_sharded)
    from vkr_tpu_torch.parallel.sharding import batch_cams, batch_states

    cfg = small_config(DRYRUN_SIZE, 8)
    scene, res = scene_and_resources(device, tex_size=32, lut_size=32)
    mesh = make_render_mesh(n, device=device)
    cams = _orbit_cams(cfg, n, device)

    def fresh():
        return FrameState.initial(cfg.height, cfg.width, device)

    def views(scene_in, states_in, cams_in):
        return render_views_sharded(scene_in, states_in, cams_in, res, cfg,
                                    mesh)

    def band(scene_in, state_in, cam_in):
        return render_frame_banded(scene_in, state_in, cam_in, res, cfg,
                                   device=device)

    view_args = (scene, batch_states(fresh, n), batch_cams(cams))
    eager = views(*view_args)
    colors, states = aot.cached_jit("views", views, view_args,
                                    donate_argnums=(1,))(*view_args)
    if not same_bits((colors, states), eager):
        _fail(f"rank {rank}: the captured views differ from the eager "
              f"views")
    coverage = float((states.prev_depth < 1.0).float().mean())
    shape = (n, cfg.height, cfg.width, 3)
    if tuple(colors.shape) != shape:
        _fail(f"rank {rank}: views of shape {tuple(colors.shape)}, not "
              f"{shape}")
    if not bool(torch.isfinite(colors).all()):
        _fail(f"rank {rank}: non-finite view colours")
    if not coverage > MIN_COVERAGE:
        _fail(f"rank {rank}: suspiciously low coverage {coverage}")

    color_1, state_1, aux_1 = render_frame(scene, fresh(), cams[0], res,
                                           cfg)
    eager = band(scene, fresh(), cams[0])
    color_b, state_b, aux_b = aot.cached_jit(
        "band", band, (scene, fresh(), cams[0]), donate_argnums=(1,))(
        scene, fresh(), cams[0])
    if not same_bits((color_b, state_b, aux_b), eager):
        _fail(f"rank {rank}: the captured band frame differs from the "
              f"eager band frame")
    for k in GBUF:
        if not torch.equal(getattr(aux_b["gbuffer"], k),
                           getattr(aux_1["gbuffer"], k)):
            _fail(f"rank {rank}: the band G-buffer's {k} differs from "
                  f"the one-device frame's")
    if not torch.equal(state_b.prev_depth, state_1.prev_depth):
        _fail(f"rank {rank}: the band frame's prev_depth differs")
    overflow = (int(aux_b["overflow"]), int(aux_1["overflow"]))
    if overflow != (0, 0):
        _fail(f"rank {rank}: bin pairs dropped (band, one device) "
              f"{overflow}")
    dev = max(float((color_b - color_1).abs().max()),
              float((state_b.taa_history - state_1.taa_history).abs().max()))
    if not dev <= BAND_ATOL:
        _fail(f"rank {rank}: the band frame's colour or TAA history "
              f"deviates by {dev} from the one-device frame's")
    return {"colors_shape": shape, "coverage": coverage, "max_dev": dev,
            "band_shape": tuple(color_b.shape)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job, rank, n, port, device_type, q):
    """A spawned rank: join the gloo group, run job(rank, n, device) and
    put (rank, result) on q; on an error put its traceback, then raise.
    The error goes out before the group is torn down, which fails the
    ranks waiting on this one."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        if device_type == "cpu":
            torch.set_num_threads(1)  # ranks share the host's cores
            device = torch.device("cpu")
        else:
            device = torch.device("cuda",
                                  rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=n, rank=rank)
        q.put((rank, job(rank, n, device)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job, n: int, device_type: str, timeout_s: float) -> list:
    """Spawn n ranks that run job(rank, n, device) (job importable by
    name: a module-level function) in one gloo group, on the CPU or on
    the cards (device_type "cpu" or "cuda"). Returns their results in
    rank order. Raises RuntimeError once a rank reports an error (with
    every failed rank's traceback) or dies without a result, and
    TimeoutError once timeout_s has passed; every rank is stopped before
    it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, n, port, device_type, q))
             for r in range(n)]
    for p in procs:
        p.start()
    name = getattr(job, "__name__", "job")
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < n:
            try:
                rank, res = q.get(timeout=min(
                    1.0, max(deadline - time.monotonic(), 0.01)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead:
                    raise RuntimeError(
                        f"{name}: ranks {dead} died without a result (exit"
                        f" codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{name}: no result after {timeout_s} s from ranks"
                        f" {sorted(set(range(n)) - set(results))}")
                continue
            results[rank] = res
            if "error" in res:
                _raise_errors(name, results, q)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [results[r] for r in range(n)]


def _raise_errors(name, results, q, grace_s=1.0):
    """Raise one RuntimeError with every rank's traceback, in rank order:
    a rank's failure makes those waiting on it fail too, and the queue
    gets their reports within grace_s, not necessarily the first one's
    first."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            rank, res = q.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        results[rank] = res
    failed = {r: res["error"] for r, res in sorted(results.items())
              if "error" in res}
    raise RuntimeError("\n".join(f"{name}: rank {r} failed:\n{err}"
                                 for r, err in failed.items()))


def main() -> int:
    """entry()'s frame captured and run once, then the dry run over
    DRYRUN_DEVICES ranks (default 8). Raises on any failure."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.tools.render import synchronize

    fn, args = entry()
    frame = aot.cached_jit("entry", fn, args, donate_argnums=(1,))
    color, _ = frame(*args)
    synchronize(color.device)
    print("entry(): " + ("capture+run OK" if isinstance(
        frame, aot.CapturedFrame) else f"run OK on {color.device} (no "
        "capture off the card)"), flush=True)
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "8")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
