"""One cell on one card: set-up, the measured window, with --trace 1 the
traced window and the segment timings, then the comparison with the
reference once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import tempfile
import time
import types

import torch

from harness import check, program, trace, window
from harness.result import log
from harness.traffic import Traffic
from harness.work import GATHER_SYMBOLS, gather_bytes

TRACE_FRAMES = 12       # frames of the profiled window
SEGMENT_REPS = 10       # replays of each segment timed alone
WINDOW_MARK = "benchmark_traced_window"


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Frames:
    """The frames of one run on the program's side: the traffic's cameras,
    the captured frame, the state it carries, the frames kept for the
    check."""

    def __init__(self, built, traffic: Traffic, seed, device, render):
        self.built, self.traffic, self.seed = built, traffic, seed
        self.device, self.render = device, render
        self.state = None
        self.keeper = check.Keeper(device)
        self.kept = {}             # frame -> {"in": state, "out": outputs}
        self.pair_starts = set()

    def cam(self, k):
        t = self.traffic
        return program.camera(self.built.cfg, t.view(self.seed, k),
                              t.view(self.seed, max(k - 1, 0)), k,
                              self.device, t.jitter)

    def dispatch(self, k) -> bool:
        """Frame k; True where its replay dropped bin pairs."""
        self.keeper.before(k)
        if k in self.pair_starts:
            # frame k + 1 overwrites the state frame k reads
            self.kept.setdefault(k, {})["in"] = self.keeper.keep(
                "state", program.state_tensors(self.state), k + 1)
        colour, self.state, aux, overflowed = program.call(
            self.render, self.built, self.state, self.cam(k))
        if k in self.pair_starts or k - 1 in self.pair_starts:
            # colour and aux live until frame k + 2 replays the same graph
            self.kept.setdefault(k, {})["out"] = self.keeper.keep(
                "out", check.outputs(colour, self.state, aux), k + 2)
        return overflowed


def profiled(frames: Frames, first, n, events):
    """Frames first..first+n-1 under torch.profiler, the loop marked by
    WINDOW_MARK; returns (device intervals, host intervals, window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            window.run(frames.dispatch, None, frames.traffic.in_flight,
                       first, events,
                       keep_going=lambda k, _: k < first + n)
            sync(frames.device)
    return trace.from_profiler(prof, WINDOW_MARK)


def rank_summary(reduced, n_frames) -> dict:
    """What the per-layer readers take from one card's traced window."""
    device, host, (lo, hi) = reduced
    ops = trace.by_name(device, lo, hi)
    return {
        "frames": n_frames, "busy_s": trace.busy_seconds(device, lo, hi),
        "window_s": hi - lo, "device_ops": trace.count_in(device, lo, hi),
        "gather_s": sum(s for name, s in ops.items()
                        if any(sym in name for sym in GATHER_SYMBOLS)),
        "nccl_s": sum(s for name, s in ops.items() if "nccl" in name.lower()),
        "top_ops": trace.top_ops(device, lo, hi),
        "idle_gaps": trace.idle_gaps(device, host, lo, hi),
    }


def reference_check(config, assets, kept0, kept, pair_starts, traffic, seed,
                    device, control=False):
    """The comparison's readings. The frozen frame: frame 0 from the
    reference's own initial state, each pair (i, i + 1) from the state the
    program carried into i. The independent chain: each of those frames,
    its SSR and GTAO from the frame's own G-buffer and carried state (into
    i + 1: the one frame i left), its shading and TAA from the frozen
    frame's. With probe GI, frame 0 also compares the program's probe
    grid with the reference's own. Returns (the worst reading of each
    number, the frames compared).
    control: the reference in the control's precision (TF32), its probe
    grid too, in the program's place, against the reference itself."""
    import ref_world

    t0 = time.perf_counter()
    world = ref_world.build(config, assets, device)
    judge = ref_world.Independent(world, device)
    log(f"reference: scene, LUTs and grids built in "
        f"{time.perf_counter() - t0:.3f} s")
    control_grid = None
    if control and world.probe_grid is not None:
        with ref_world.tf32():
            control_grid = ref_world.probe_grid(world, device)

    def views(k):
        return traffic.view(seed, k), traffic.view(seed, max(k - 1, 0))

    march = {}
    with ref_world.recording(march) as at_frame:
        def frame(state, k, tf32=False):
            at_frame(None if tf32 else k)
            with ref_world.tf32() if tf32 else contextlib.nullcontext():
                return ref_world.render(world, state, *views(k), k, device,
                                        traffic.jitter,
                                        grid=control_grid if tf32 else None)

        def state_of(out):
            return {f: out[f"state.{f}"] for f in check.STATE_FIELDS}

        spent = {"independent": 0.0}
        fills = []

        def independent(prog, state_in, k, frozen, frozen_state):
            t = time.perf_counter()
            expected = judge.expected(prog, state_in, *views(k), march[k],
                                      frozen, frozen_state)
            out = check.compare_groups(prog, expected)
            if "ind_probe" in expected:
                fills.append(check.probe_fill(prog["probe"],
                                              march[k]["rays"]))
            spent["independent"] += time.perf_counter() - t
            return out

        readings = []
        t0 = time.perf_counter()
        init = ref_world.initial_state(world, device)
        start = frame(init, 0)
        if control:
            kept0 = check.outputs(*frame(ref_world.initial_state(
                world, device), 0, tf32=True))
            if control_grid is not None:
                kept0.update(check.grid_outputs(control_grid))
        init_fields = {f: getattr(init, f) for f in check.STATE_FIELDS}
        ref0 = check.outputs(*start)
        if world.probe_grid is not None:
            ref0.update(check.grid_outputs(world.probe_grid))
        readings.append(check.compare(kept0, ref0))
        readings.append(independent(kept0, init_fields, 0, ref0,
                                    init_fields))
        for i in sorted(pair_starts):
            if i not in kept or "in" not in kept[i] or i + 1 not in kept:
                continue
            state_in = ref_world.state_from(kept[i]["in"], device)
            ref_i = frame(state_in, i)
            ref_i1 = frame(ref_i[1], i + 1)
            if control:
                ctl_i = frame(state_in, i, tf32=True)
                ctl_i1 = frame(ctl_i[1], i + 1, tf32=True)
                prog_i = check.outputs(*ctl_i)
                prog_i1 = check.outputs(*ctl_i1)
            else:
                prog_i, prog_i1 = kept[i]["out"], kept[i + 1]["out"]
            out_i, out_i1 = check.outputs(*ref_i), check.outputs(*ref_i1)
            readings.append(check.compare(prog_i, out_i))
            readings.append(check.compare(prog_i1, out_i1))
            readings.append(independent(prog_i, kept[i]["in"], i, out_i,
                                        kept[i]["in"]))
            readings.append(independent(prog_i1, state_of(prog_i), i + 1,
                                        out_i1, state_of(out_i)))
    log(f"reference: {len(readings)} frames compared in "
        f"{time.perf_counter() - t0:.3f} s, the independent chain's "
        f"{spent['independent']:.3f} s of it")
    out = check.worst(readings)
    if fills:
        # not compared: the least share of SSR-empty pixels probes fill
        out["probe_fill_min"] = min(fills)
        log(f"probe hits fill {fills} of the SSR-empty pixels, frame by "
            f"frame")
    return out, len(readings) // 2


def warm_up(frames: Frames, traffic, device) -> float:
    """The traffic's warm-up frames after the capture, one at a time;
    returns their mean ms."""
    t0 = time.perf_counter()
    for k in range(1, traffic.warmup_frames + 1):
        frames.dispatch(k)
        sync(device)
    return (time.perf_counter() - t0) / max(traffic.warmup_frames, 1) * 1e3


def checked_frames(seed, traffic, first, seconds, warm_ms):
    """The checked pairs' first frames, drawn from the seed among the
    frames the window is sure to reach: half of what the warm-up frames'
    serial time (warm_ms a frame) gives for the window's length."""
    reach = int(seconds * 1e3 / max(warm_ms, 1e-3) / 2)
    return check.draw_pairs(seed, traffic.checked_pairs, first + 1,
                            first + 1 + max(reach - 2,
                                            2 * traffic.checked_pairs))


def run_cell(cell, seed, seconds, traced, device, t_process, *,
             control=False, hook=None):
    """The cell once: the outcome the result line is made of. hook: called
    first (run.main's)."""
    if hook is not None:
        hook()
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = Traffic.load(cell.traffic_path)
    events = window.Events(cuda)
    with tempfile.TemporaryDirectory(prefix="benchmark_inputs_") as tmp:
        t_inputs = time.perf_counter()
        assets = program.write_inputs(cell.config, seed, tmp)
        # the benchmark's own input files are no user's start-up
        inputs_s = time.perf_counter() - t_inputs
        built = program.build(cell.config, assets, device,
                              lambda: sync(device))
        log(f"inputs written in {inputs_s:.3f} s (not set-up); scene, "
            f"upload, LUTs and grid: {built.scene_load_s:.3f} s")
        cfg = built.cfg
        frames = Frames(built, traffic, seed, device, None)
        frames.state = program.initial_state(cfg, device)
        fn = program.frame_fn(built)
        gathers = []
        cam0 = frames.cam(0)
        with (program.recording_gathers(gathers) if traced
              else contextlib.nullcontext()):
            frames.render = program.captured(cell.name, fn, built,
                                             frames.state, cam0)
            colour, frames.state, aux, _ = program.call(
                frames.render, built, frames.state, cam0)
        kept0 = check.outputs(colour, frames.state, aux)
        if built.probe_grid is not None:
            kept0.update(check.grid_outputs(built.probe_grid))
        kept0 = {k: t.cpu().clone() for k, t in kept0.items()}
        capture_s = getattr(frames.render, "capture_seconds", None)
        # the check's host buffers, then the warm-up frames
        frames.keeper.reserve("state", program.state_tensors(frames.state),
                              traffic.checked_pairs)
        frames.keeper.reserve("out", check.outputs(colour, frames.state, aux),
                              2 * traffic.checked_pairs)
        warm_ms = warm_up(frames, traffic, device)
        first = traffic.warmup_frames + 1
        frames.pair_starts = set(checked_frames(seed, traffic, first,
                                                seconds, warm_ms))
        setup_s = time.perf_counter() - t_process - inputs_s
        log(f"set-up {setup_s:.3f} s (capture {capture_s}, warm-up frame "
            f"{warm_ms:.3f} ms serial); checked pairs from frames "
            f"{sorted(frames.pair_starts)}")

        win = window.run(frames.dispatch, seconds, traffic.in_flight, first,
                         events)
        sync(device)
        frames.keeper.finish()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        n = win.frames
        log(f"window: {n} frames in {win.end - win.start:.3f} s, "
            f"{win.failed} overflowed; {window.describe(win)}")

        ctx = types.SimpleNamespace(
            scene_load_s=built.scene_load_s, probe_grid_s=built.probe_grid_s,
            capture_s=capture_s,
            host_call_s=[win.host_call_s], segments_ms=None,
            gather_bytes_per_frame=None, ranks=[])
        breakdown = None
        if traced and cuda:
            nxt = first + n
            reduced = profiled(frames, nxt, TRACE_FRAMES, events)
            if reduced is not None:
                ctx.ranks.append(rank_summary(reduced, TRACE_FRAMES))
            ctx.segments_ms = program.segment_ms(
                built, frames.state, frames.cam(nxt + TRACE_FRAMES),
                SEGMENT_REPS, device)
            if gathers and fn.runs:
                ctx.gather_bytes_per_frame = sum(
                    gather_bytes(name, imgs, offs, r)
                    for name, imgs, offs, r in gathers) / fn.runs
            log(f"gathers: {len(gathers)} calls recorded over {fn.runs} "
                f"runs of the frame, {ctx.gather_bytes_per_frame} bytes a "
                f"frame; device s in the traced window "
                f"{[r['gather_s'] for r in ctx.ranks]}")
            if ctx.ranks:
                breakdown = {"device_ops": ctx.ranks[0]["top_ops"],
                             "idle_gaps": ctx.ranks[0]["idle_gaps"]}
        kept, pair_starts = frames.kept, frames.pair_starts
        del frames, built, fn, colour, aux
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        readings, n_checked = reference_check(
            cell.config, assets, kept0, kept, pair_starts, traffic, seed,
            device, control=control)
    return dict(window=win, peak=peak, setup_s=setup_s, ctx=ctx,
                breakdown=breakdown, readings=readings, n_checked=n_checked)
