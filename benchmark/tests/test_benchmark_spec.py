"""BENCHMARK.json: it parses, keeps its shape and limits, and every
cell finds its configuration, traffic and metric files by name; a cell,
configuration, traffic mix and metric added as new files and entries are
found without an edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from bench_helpers import BENCH, ROOT
from harness import spec
from harness.traffic import Traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def test_top_level_and_sizes(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    n_cells = 24  # the limit run_seconds must fit with
    full = 2 + 14 * n_cells
    assert full * (bench["run_seconds"] + 60) + n_cells * 180 + 1200 \
        <= 43200


def test_names_units_and_entries(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"frame_ms", "frame_p95_ms", "peak_mem_GiB", "setup_s"}
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], ROOT)
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        Traffic.load(cell.traffic_path)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"], ROOT))


def test_configs_name_their_source(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["chips"] == next(w["chips"] for w in bench["workloads"]
                                     if w["config"] == c["name"])


def test_new_files_and_entries_are_found(tmp_path, bench):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as new files in a copy, with a cell that uses them."""
    root = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = json.loads(json.dumps(bench))
    with open(os.path.join(ROOT, b["configs"][0]["file"])) as f:
        conf = json.load(f)
    conf["name"] = "throwaway_config"
    with open(os.path.join(root, "benchmark/configs/throwaway_config.json"),
              "w") as f:
        json.dump(conf, f)
    with open(os.path.join(root, "benchmark/traffic/orbit_loop.json")) as f:
        mix = json.load(f)
    mix["hi_rad"] = 0.05
    with open(os.path.join(root, "benchmark/traffic/throwaway_mix.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark/metrics/throwaway_metric.py"),
              "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "throwaway_config", "source": "x",
                         "file": "benchmark/configs/throwaway_config.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway_cell",
                           "config": "throwaway_config",
                           "traffic": "throwaway_mix", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "throwaway_metric", "unit": "count",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "frame_ms",
                           "workloads": ["throwaway_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = spec.resolve("throwaway_cell", root)
    assert cell.config["name"] == "throwaway_config"
    assert Traffic.load(cell.traffic_path).hi_rad == 0.05
    assert "throwaway_metric" in {m["name"] for m in cell.per_layer}
    ctx = type("Ctx", (), {})()
    assert spec.load_reader("throwaway_metric", root)(ctx) == 42.0
    # the throwaway metric lists only its own cell
    other = spec.resolve(bench["workloads"][0]["name"], root)
    assert "throwaway_metric" not in {m["name"] for m in other.per_layer}


def test_a_missing_file_is_named(tmp_path, bench):
    root = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = json.loads(json.dumps(bench))
    b["workloads"][0]["traffic"] = "no_such_mix"
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        spec.resolve(b["workloads"][0]["name"], root)


def _config(name="sponza_tex_1440p"):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["sponza_tex_1440p", "colonnade_rt_1440p",
                                  "colonnade_band4_1440p",
                                  "sponza_probes_1440p"])
def test_every_configuration_file_is_run_as_stated(name):
    import ref_world
    from vkr_ref.config import RenderConfig

    from harness import program

    conf = _config(name)
    program.honoured(conf)
    ref_world.judged(RenderConfig.from_json(json.dumps(conf["render"])))


@pytest.mark.parametrize("edit,match", [
    (lambda c: c.update(probe_grid={"margin": 0.5}), "enable_probes"),
    (lambda c: c.update(shadow_map={"size": 1024}), "keys"),
    (lambda c: c["scene"].update(kind="gltf"), "scene kind"),
    (lambda c: c["scene"].update(path="Sponza.gltf"), "scene keys"),
    (lambda c: c["render"].update(enable_probes=True), "probe"),
    (lambda c: c["render"]["gtao"].update(use_ray_query=True), "tri_grid"),
])
def test_a_setting_the_harness_would_not_run_is_refused(edit, match):
    from harness import program

    conf = _config()
    edit(conf)
    with pytest.raises(ValueError, match=match):
        program.honoured(conf)


@pytest.mark.parametrize("edit", [
    lambda r: r.update(enable_taa=False),
    lambda r: r.update(show_ao_only=True),
    lambda r: r["gtao"].update(mis=False),
    lambda r: r["ssr"].update(use_blur=False),
])
def test_a_frame_the_independent_chain_cannot_judge_is_refused(edit):
    import ref_world
    from vkr_ref.config import RenderConfig

    conf = _config()
    edit(conf["render"])
    with pytest.raises(ValueError):
        ref_world.judged(RenderConfig.from_json(json.dumps(conf["render"])))
