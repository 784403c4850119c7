"""What BENCHMARK.json asks of one cell, found by name: the cell, its
configuration file, its traffic file and the readers of its per-layer
metrics.

    configs/<config>.json      the configuration as it is run
    traffic/<mix>.json         the traffic mix's parameters
    metrics/<metric>.py        a per-layer metric's reader: read(ctx)

A later cell, configuration, mix or metric is new files and new entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic_path: str
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    root: str


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: str = ROOT) -> Cell:
    """The cell named cell_name, with its files read; raises KeyError or
    FileNotFoundError naming what is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"{cell_name}: no configuration {w['config']!r}")
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    traffic = os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")
    if not os.path.exists(traffic):
        raise FileNotFoundError(f"{cell_name}: no traffic file {traffic}")
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell_name)]
    for m in per_layer:
        reader_path(m["name"], root)
    return Cell(name=cell_name, chips=int(w["chips"]), config=config,
                traffic_path=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell_name)],
                per_layer=per_layer, root=root)


def reader_path(metric: str, root: str = ROOT) -> str:
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"per-layer metric {metric!r} has no reader "
                                f"{path}")
    return path


def load_reader(metric: str, root: str = ROOT):
    """The read(ctx) function of metrics/<metric>.py."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx) -> dict:
    """{name: {"value", "unit"}} of every per-layer metric of the cell
    whose reader found something to read (a reader returns None when it
    did not)."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
