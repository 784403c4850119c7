#!/usr/bin/env python3
"""The benchmark of vkr_tpu_torch: one cell of BENCHMARK.json, run once.

    python3 benchmark/run.py --workload sponza_orbit --seed 7 \
        --seconds 20 --trace 0

Builds the cell's scene from its configuration (benchmark/configs) and
the seed, captures the frame (vkr_tpu_torch.core.aot.cached_jit), renders
the traffic's warm-up frames, then drives the frame for --seconds in a
closed loop with the traffic's frames in flight (benchmark/traffic), and
compares frames of the window with the references (benchmark/reference:
the frozen plain frame, and the independent image-space chain) once the
window has closed. --trace 1 runs the
same, then a profiled window and the segments captured alone, and prints
the per-layer metrics (benchmark/metrics) in place of the end-to-end
ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared beside their limits (checks), which are also the last lines of
standard error. It needs the cards the cell asks for: without them it
exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# every build and kernel cache of the run inside the checkout, at fixed
# paths (the port builds its CUDA and native libraries into
# vkr_tpu_torch/build/ and keeps its LUTs in .vkr_cache/ by itself)
CACHE = os.path.join(BENCH, ".cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))

GIB = 1 << 30


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def end_to_end(cell, out) -> dict:
    """The cell's end-to-end metrics from the run's outcome."""
    win = out["window"]
    from harness import window

    values = {
        "frame_ms": window.frame_ms(win.start, win.completions),
        "frame_p95_ms": window.frame_p95_ms(win.start, win.completions),
        "peak_mem_GiB": out["peak"] / GIB,
        "setup_s": out["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def main(argv=None, *, device=None, root=ROOT, t_process=None, hook=None):
    """Run the cell; returns the exit code. device, root and hook are for
    the CPU tests, which drive a run without a card, on a checkout of
    their own, with hook() called in every process of the run before its
    scene is built (to break the timed path underneath): a run from the
    command line takes the cards and the checkout it finds."""
    args = parse(argv)
    from harness import check, result, spec

    cell = spec.resolve(args.workload, root)
    import torch

    torch.set_num_threads(4)
    if device is None:
        if not torch.cuda.is_available():
            result.log("ERROR: no CUDA device: the benchmark measures the "
                       "port on the card and has no fallback")
            return 2
        if torch.cuda.device_count() < cell.chips:
            result.log(f"ERROR: {cell.name} needs {cell.chips} CUDA devices, "
                       f"{torch.cuda.device_count()} found")
            return 2
        device = "cuda:0"
    t0 = T_PROCESS if t_process is None else t_process
    if cell.chips > 1 or "band" in cell.config:
        from harness import band

        out = band.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, t0, hook=hook)
    else:
        from harness import single

        out = single.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, t0, hook=hook)
    cuda = str(device).startswith("cuda")
    card = result.power_limit() if cuda else "cpu"
    if args.trace:
        metrics = spec.read_per_layer(cell, out["ctx"])
    else:
        metrics = end_to_end(cell, out)
    for name, m in metrics.items():
        result.log(f"{name}: {m['value']!r} {m['unit']} ({card})")
    ranks = out["ctx"].ranks
    busy = window_s = None
    if args.trace and ranks:
        busy = sum(r["busy_s"] for r in ranks) / len(ranks)
        window_s = sum(r["window_s"] for r in ranks) / len(ranks)
    limits = check.limits_of(cell.config)
    line = {
        "correct": check.verdict(out["readings"], limits),
        "attempted": out["window"].frames,
        "failed": out["window"].failed,
        "metrics": metrics,
        "device": (result.device_info(cell.chips, out["peak"], busy,
                                      window_s) if cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}),
    }
    if args.trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    result.log(f"compared {out['n_checked']} frames with the reference")
    return result.emit(line, check.checks_line(out["readings"], limits))


if __name__ == "__main__":
    sys.exit(main())
