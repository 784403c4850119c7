#!/usr/bin/env python3
"""The readings the comparison's limits are set from, many seeds in one
process (one CUDA start-up and one kernel build for all of them):

    python3 benchmark/readings.py --workload sponza_orbit \
        --seeds 101,102,103 --seconds 3            # the program's readings
    python3 benchmark/readings.py --workload sponza_orbit \
        --seeds 201,202,203 --seconds 3 --control 1

Each seed is one run of the cell as benchmark/run.py makes it, with a
short window; its line on standard output is the seed and the numbers compared. --control 1 puts
the control in the program's place: the reference computed with float32
products in TF32 (the nearest precision below the configuration's
float32 with TF32 off), on the states the program carried into the
checked frames, against the reference itself.
The control of a band cell runs on one card: its frames are the
one-card frame's, bit for bit (parallel/band.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.join(BENCH, "reference"), BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402  (the run's cache directories and paths)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from harness import check, result, single, spec

    if not torch.cuda.is_available():
        result.log("ERROR: no CUDA device")
        return 2
    cell = spec.resolve(args.workload, run.ROOT)
    band_cell = "band" in cell.config
    if band_cell and args.control:
        cell = dataclasses.replace(cell, chips=1)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if band_cell and not args.control:
            from harness import band

            out = band.run_cell(cell, seed, args.seconds, False, "cuda:0",
                                t0)
        else:
            out = single.run_cell(cell, seed, args.seconds, False, "cuda:0",
                                  t0, control=bool(args.control))
        r = out["readings"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control,
                          "correct": check.verdict(
                              r, check.limits_of(cell.config)),
                          "readings": {k: result.finite(v)
                                       for k, v in r.items()},
                          "frames": out["window"].frames,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
