"""One cell of the band frame: one rank per card, each a process of its
own (torch.multiprocessing, spawn), joined by torch.distributed over the
configuration's backend (NCCL) at a free localhost port.

Every rank builds the scene, captures the band frame and runs the same
frames: the warm-up, then the window, whose end rank 0 decides and
announces through the group's store a few frames ahead, so that every
rank stops after the same frame (a rank cannot run more than one frame
ahead of another: each call of a collective frame waits for the previous
call's overflow reading, which needs every rank's gathers). A frame
completes when its slowest rank completes it: the window's completion
times are, frame by frame, the latest over the ranks (one host clock,
CLOCK_MONOTONIC, serves every process).

Rank 0 keeps the checked frames (every rank returns the whole frame) and,
once the process group is torn down, compares them with the reference on
its card. The launcher, which runs nothing on a card, prints the result.
"""

from __future__ import annotations

import gc
import queue as _queue
import socket
import tempfile
import time
import traceback
import types

STOP_KEY = "benchmark_window_stop"
STOP_AHEAD = 2           # frames past rank 0's last window frame
RESULT_TIMEOUT_S = 330.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def agreed_stop(store, rank, key, seconds):
    """keep_going for window.run that every rank answers alike: rank 0
    ends the loop once `seconds` have passed, STOP_AHEAD frames on, and
    posts that frame under key in the group's store; the others run until
    they read it and reach it."""
    stop = {"at": None}

    def keep_going(k, elapsed):
        if stop["at"] is None:
            if rank == 0 and elapsed >= seconds:
                stop["at"] = k + STOP_AHEAD
                store.set(key, str(stop["at"]))
            elif rank != 0 and store.check([key]):
                stop["at"] = int(store.get(key))
        return stop["at"] is None or k < stop["at"]
    return keep_going


def _rank(rank, n, port, cell, seed, seconds, traced, device_kind,
          backend, t_process, out, hook):
    """One rank's run; rank 0 puts ("ok", result) or ("error", text) on
    out, every other rank ("done", forbidden modules) or an error."""
    try:
        if hook is not None:
            hook()
        res = _rank_body(rank, n, port, cell, seed, seconds, traced,
                         device_kind, backend, t_process)
        out.put(("ok", res) if rank == 0 else ("done", res))
    except BaseException:
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def _rank_body(rank, n, port, cell, seed, seconds, traced, device_kind,
               backend, t_process):
    import torch
    import torch.distributed as dist

    from harness import check, program, result, single, window
    from harness.traffic import Traffic

    torch.set_num_threads(2)
    cuda = device_kind == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        store = dist.distributed_c10d._get_default_store()
        traffic = Traffic.load(cell.traffic_path)
        events = window.Events(cuda)
        with tempfile.TemporaryDirectory(prefix="benchmark_inputs_") as tmp:
            t_inputs = time.perf_counter()
            assets = program.write_inputs(cell.config, seed, tmp)
            # the benchmark's own input files are no user's start-up
            inputs_s = time.perf_counter() - t_inputs
            built = program.build(cell.config, assets, device,
                                  lambda: single.sync(device))
            frames = single.Frames(built, traffic, seed, device, None)
            frames.state = program.initial_state(built.cfg, device)
            fn = program.frame_fn(built, group=dist.group.WORLD,
                                  device=device)
            cam0 = frames.cam(0)
            frames.render = program.captured(cell.name, fn, built,
                                             frames.state, cam0)
            colour, frames.state, aux, _ = program.call(
                frames.render, built, frames.state, cam0)
            capture_s = getattr(frames.render, "capture_seconds", None)
            kept0 = None
            if rank == 0:
                kept0 = {k: t.cpu().clone() for k, t in
                         check.outputs(colour, frames.state, aux).items()}
                frames.keeper.reserve(
                    "state", program.state_tensors(frames.state),
                    traffic.checked_pairs)
                frames.keeper.reserve(
                    "out", check.outputs(colour, frames.state, aux),
                    2 * traffic.checked_pairs)
            warm_ms = single.warm_up(frames, traffic, device)
            first = traffic.warmup_frames + 1
            if rank == 0:
                frames.pair_starts = set(single.checked_frames(
                    seed, traffic, first, seconds, warm_ms))
            dist.barrier()
            setup_s = time.perf_counter() - t_process - inputs_s
            win = window.run(frames.dispatch, None, traffic.in_flight,
                             first, events,
                             keep_going=agreed_stop(store, rank, STOP_KEY,
                                                    seconds))
            single.sync(device)
            frames.keeper.finish()
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            summary = None
            if traced and cuda:
                reduced = single.profiled(frames, first + win.frames,
                                          single.TRACE_FRAMES, events)
                if reduced is not None:
                    summary = single.rank_summary(reduced,
                                                  single.TRACE_FRAMES)
            mine = dict(completions=win.completions, start=win.start,
                        host_call_s=win.host_call_s, failed=win.failed,
                        peak=peak, scene_load_s=built.scene_load_s,
                        capture_s=capture_s, setup_s=setup_s,
                        summary=summary,
                        forbidden=result.forbidden_modules())
            everyone = [None] * n
            dist.all_gather_object(everyone, mine)
            kept, pair_starts = frames.kept, frames.pair_starts
            del frames, built, fn, colour, aux
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            dist.barrier()
            dist.destroy_process_group()
            if rank != 0:
                return result.forbidden_modules()
            readings, n_checked = single.reference_check(
                cell.config, assets, kept0, kept, pair_starts, traffic,
                seed, device)
        return _merge(everyone, readings, n_checked)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _merge(everyone, readings, n_checked) -> dict:
    """The run's outcome from every rank's: a frame completes with its
    slowest rank; memory, set-up and host time are the largest rank's."""
    from harness import window

    ends = [max(c) for c in zip(*(r["completions"] for r in everyone))]
    win = window.Window(start=everyone[0]["start"], completions=ends,
                        host_call_s=everyone[0]["host_call_s"],
                        failed=max(r["failed"] for r in everyone))

    def top(key):
        vals = [r[key] for r in everyone if r[key] is not None]
        return max(vals) if vals else None

    ranks = [r["summary"] for r in everyone if r["summary"] is not None]
    ctx = types.SimpleNamespace(
        scene_load_s=top("scene_load_s"), capture_s=top("capture_s"),
        host_call_s=[r["host_call_s"] for r in everyone], segments_ms=None,
        gather_bytes_per_frame=None, ranks=ranks)
    breakdown = None
    if ranks:
        slowest = max(ranks, key=lambda r: r["busy_s"] / r["window_s"])
        breakdown = {"device_ops": slowest["top_ops"],
                     "idle_gaps": slowest["idle_gaps"]}
    forbidden = sorted({m for r in everyone for m in r["forbidden"]})
    return dict(window=win, peak=top("peak"),
                setup_s=everyone[0]["setup_s"], ctx=ctx, breakdown=breakdown,
                readings=readings, n_checked=n_checked, forbidden=forbidden)


def run_cell(cell, seed, seconds, traced, device, t_process, hook=None):
    """Spawn the ranks, wait for rank 0's outcome and for every rank to
    end; raises if a rank fails or the outcome does not come in time.
    hook: called first in every rank (run.main's)."""
    import torch.multiprocessing as mp

    n = int(cell.config["band"]["ranks"])
    cuda = str(device).startswith("cuda")
    backend = cell.config["band"]["backend"] if cuda else "gloo"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(
        r, n, port, cell, seed, seconds, traced, "cuda" if cuda else "cpu",
        backend, t_process, out, hook)) for r in range(n)]
    for p in procs:
        p.start()
    outcome, errors, done = None, [], 0
    deadline = time.monotonic() + RESULT_TIMEOUT_S
    try:
        while done < n and not errors:
            try:
                kind, payload = out.get(timeout=max(
                    1.0, deadline - time.monotonic()))
            except _queue.Empty:
                errors.append("no outcome from the ranks in time")
                break
            if kind == "error":
                errors.append(payload)
            else:
                done += 1
                if kind == "ok":
                    outcome = payload
                elif payload:
                    errors.append(f"a rank loaded {payload}")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("band run failed:\n" + "\n".join(errors))
    if outcome["forbidden"]:
        raise RuntimeError(f"a rank loaded {outcome['forbidden']}")
    return outcome
