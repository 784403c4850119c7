"""Paths and a tiny copy of the benchmark for the benchmark's tests."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_root(dst, width=128, height=64, bench=None):
    """A copy of the benchmark (BENCHMARK.json and benchmark/) under dst
    whose configurations render width x height on a small scene: the
    colonnade at tessellation 4 with 16² textures, 64² LUTs, the stand-in's
    PNGs at 1/16 of their size, a scene grid of 8³ cells, with probe GI a
    2x2 probe grid of 32² cube faces and the published 256² octahedral
    maps (whose 9 mips the march needs its 25 steps for). Returns dst."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bj = json.load(f) if bench is None else bench
    for c in bj["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        conf["render"].update(width=width, height=height)
        conf["render"]["ssr"]["lut_size"] = 64
        conf["scene"].update(tessellation=4, tex_size=16)
        if "standin_scale" in conf["scene"]:
            conf["scene"]["standin_scale"] = 1 / 16
        if "tri_grid" in conf:
            conf["tri_grid"] = {"resolution": 8, "cap": 24}
        if conf["render"]["enable_probes"]:
            conf["render"]["probes"] = {"oct_size": 256, "cube_size": 32,
                                        "grid": 2}
        with open(os.path.join(dst, c["file"]), "w") as f:
            json.dump(conf, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bj, f)
    return dst
