"""The probe frame's cell (probe_orbit) on the CPU at a tiny size (a 128x64
frame, a 2x2 probe grid of 32² cube faces and 256² octahedral maps): the
configuration checks, a sound run against both references, and runs with
the probe path broken underneath, which the probe groups catch."""

from __future__ import annotations

import json
import os

import pytest

import bench_helpers
from harness import check, program
from test_benchmark_faults import run_tiny

NO_PROBE_CHECKS = ["colour", "gbuffer", "ssr", "ao", "state", "overflow",
                   "ind_ssr", "ind_ao", "ind_colour"]


def _config(name):
    with open(os.path.join(bench_helpers.BENCH, "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def _without_grid(c):
    del c["probe_grid"]


def _grid_without_probes(c):
    c["render"]["enable_probes"] = False


def _grid_with_another_key(c):
    c["probe_grid"]["spacing"] = 2.0


@pytest.mark.parametrize("edit,match", [
    (_without_grid, "without a probe_grid"),
    (_grid_without_probes, "without enable_probes"),
    (_grid_with_another_key, "probe_grid keys"),
])
def test_probes_and_their_grid_come_together(edit, match):
    conf = _config("sponza_probes_1440p")
    program.honoured(conf)
    edit(conf)
    with pytest.raises(ValueError, match=match):
        program.honoured(conf)


@pytest.mark.parametrize("name", ["sponza_tex_1440p", "colonnade_rt_1440p"])
def test_configs_without_probes_keep_their_checks(name):
    assert list(check.limits_of(_config(name))) == NO_PROBE_CHECKS


@pytest.fixture
def restore():
    """Put back what a fault patched in this process."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.passes import probes

    saved = (frame.build_probe_grid, probes._trace_segment,
             probes.TRACE_STEPS)
    yield
    (frame.build_probe_grid, probes._trace_segment,
     probes.TRACE_STEPS) = saved


def test_sound_probe_run_is_correct(tmp_path):
    rc, line = run_tiny(tmp_path, "probe_orbit")
    assert rc == 0 and line["correct"] is True
    checks = line["checks"]
    assert list(checks) == NO_PROBE_CHECKS + ["probe", "ind_probe"]
    assert checks["probe"]["value"] == 0 and checks["overflow"]["value"] == 0
    assert checks["ind_probe"]["value"] <= checks["ind_probe"]["limit"]


def neighbour_dropped():
    """The probe trace's first neighbour never settles a pixel."""
    from vkr_tpu_torch.passes import probes

    real = probes._trace_segment

    def broken(*args, **kw):
        code, uv = real(*args, **kw)
        code = code.clone()
        code[0] = 0
        return code, uv
    probes._trace_segment = broken


def fewer_steps():
    """The probe march stops after 24 steps, not 25."""
    from vkr_tpu_torch.passes import probes

    probes.TRACE_STEPS = 24


def grid_altered():
    """The probe grid's colours 5% off where the grid is built."""
    from vkr_tpu_torch import frame

    real = frame.build_probe_grid

    def broken(*args, **kw):
        grid = real(*args, **kw)
        return grid._replace(colors=grid.colors * 1.05)
    frame.build_probe_grid = broken


@pytest.mark.parametrize("fault", [neighbour_dropped, fewer_steps,
                                   grid_altered])
def test_a_broken_probe_path_is_not_correct(tmp_path, restore, fault):
    rc, line = run_tiny(tmp_path, "probe_orbit", hook=fault)
    assert rc == 0 and line["correct"] is False
    for g in ("probe", "ind_probe"):
        assert line["checks"][g]["value"] > line["checks"][g]["limit"], g


@pytest.mark.card
def test_the_probe_control_is_not_correct(tmp_path, card):
    """The reference with TF32 products, its probe grid too, in the
    program's place, at a small size on the card, fails the comparison
    (the cell's readings on the chip are in PERF.md)."""
    from harness import single, spec

    root = bench_helpers.tiny_root(str(tmp_path), 480, 272)
    cell = spec.resolve("probe_orbit", root)
    out = single.run_cell(cell, 9, 1.0, False, card, 0.0, control=True)
    assert not check.verdict(out["readings"], check.limits_of(cell.config))
