"""The port's bench program (vkr_tpu_torch/tools/bench.py) on the CPU:
_merge_flushed against bench.py's own, the BENCH_FRAMES range exit before
any scene is built, main() end to end in both loop modes, the overflow
and coverage gates, the breakdown's failure kept off the headline, the
order of dispatches and waits with frames in flight, the card it needs
and the Sponza scene it will not swap for the colonnade.

main() runs at 128x64 on the 24-column hall at tessellation 4 (the bench
eye is inside it) with the SSR LUTs at 64²: the bench's 1024² LUTs take
about a minute on a CPU. No Pallas kernel is interpreted."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's stats line: coverage, frames, min/median/max, p10/p90,
# trimmed mean, merged pairs
COVERAGE_LINE = chip_smoke.BENCH_STATS


def _bench_py():
    """bench.py at the repository's root (JAX): the reference program."""
    spec = importlib.util.spec_from_file_location(
        "vkr_tpu_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("VKR_PLATFORM", "cpu")
    monkeypatch.setenv("VKR_DISK_CACHE", str(tmp_path / "cache"))
    for name in ("BENCH_RES", "BENCH_FRAMES", "BENCH_SSR_ITERS",
                 "BENCH_SCENE", "BENCH_TEX", "BENCH_PIPELINE",
                 "BENCH_BREAKDOWN", "BENCH_STARTUP_PROFILE"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def small(monkeypatch):
    """The bench's colonnade and LUTs at test size; returns the list of
    frames render_frame was called for (their frame_index)."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.scene import procedural

    colonnade, luts = procedural.colonnade_scene, frame.build_ssr_resources
    render_frame = frame.render_frame
    calls = []

    def counted(scene, state, cam, *a, **kw):
        calls.append(int(state.frame_index))
        return render_frame(scene, state, cam, *a, **kw)

    monkeypatch.setattr(procedural, "colonnade_scene", lambda **kw: colonnade(
        columns=24, tessellation=4, tex_size=32))
    monkeypatch.setattr(frame, "build_ssr_resources",
                        lambda size, device: luts(64, device=device))
    monkeypatch.setattr(frame, "render_frame", counted)
    monkeypatch.setenv("BENCH_SCENE", "colonnade")
    monkeypatch.setenv("BENCH_RES", "128x64")
    return calls


def _no_scene(monkeypatch):
    """Make building either bench scene fail the test."""
    from vkr_tpu_torch.scene import procedural

    def refuse(**kw):
        raise AssertionError("a bench scene was built")

    monkeypatch.setattr(procedural, "colonnade_scene", refuse)
    monkeypatch.setattr(procedural, "sponza_colonnade_scene", refuse)


def _headline(out):
    """The last stdout line, parsed, held to bench.py's four keys."""
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == chip_smoke.BENCH_KEYS
    assert line["metric"] == "1080p_full_pipeline_frame_time"
    assert line["unit"] == "ms"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 16.0, 3)
    return line


def _times(seed, pairs):
    """15 seeded completion intervals around 80 ms; with pairs, two
    double-flush pairs (one interval ~1.8x the median, the next ~0.2x)."""
    rng = np.random.default_rng(seed)
    t = list(rng.normal(0.080, 0.004, 15))
    if pairs:
        for i in rng.choice(np.arange(0, 13, 3), 2, replace=False):
            share = rng.uniform(1.7, 1.9)
            t[i], t[i + 1] = 0.080 * share, 0.080 * (2.0 - share)
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pairs", [False, True])
def test_merge_flushed_is_bench_pys(seed, pairs):
    """The port's _merge_flushed returns what bench.py's returns, on
    intervals with and without double-flush pairs."""
    from vkr_tpu_torch.tools import bench

    times = _times(seed, pairs)
    median = float(np.median(times))
    got = bench._merge_flushed(times, median)
    want = _bench_py()._merge_flushed(times, median)
    assert got == want
    assert (got[1] == 2) if pairs else (got[1] == 0)


@pytest.mark.parametrize("frames", ["1", "19"])
def test_frames_out_of_range_exit_before_the_scene(frames, monkeypatch,
                                                   capsys):
    """BENCH_FRAMES outside [2, 18]: bench.py's error, exit code 1, no
    scene built and no scene+LUTs line."""
    from vkr_tpu_torch.tools import bench

    _no_scene(monkeypatch)
    monkeypatch.setenv("BENCH_FRAMES", frames)
    assert bench.main([]) == 1
    out, err = capsys.readouterr()
    assert (f"ERROR: BENCH_FRAMES={frames} out of range [2, 18] (>18 exits "
            "the hall enclosure; <2 has no timed frame)") in err
    assert "scene+LUTs" not in err and out == ""


@pytest.mark.parametrize("env", [
    {"BENCH_PIPELINE": "1", "BENCH_BREAKDOWN": "1"},
    {"BENCH_PIPELINE": "0", "BENCH_BREAKDOWN": "1"},
    {"BENCH_BREAKDOWN": "auto", "BENCH_STARTUP_PROFILE": "1"},
], ids=["pipelined", "serial", "auto-startup-profile"])
def test_bench_end_to_end(env, small, monkeypatch, capsys):
    """main() at 128x64, 3 frames: exit code 0, the headline's four keys
    last on stdout, the coverage line over the 2 timed frames, the three
    breakdown lines and their sum on stderr (BENCH_BREAKDOWN=auto runs
    it after a start-up under 900 s), and the start-up split (build,
    warm-up plus capture, first replay) where BENCH_STARTUP_PROFILE asks
    for it."""
    from vkr_tpu_torch.tools import bench

    monkeypatch.setenv("BENCH_FRAMES", "3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench.main([]) == 0
    out, err = capsys.readouterr()
    _headline(out)
    assert len(out.strip().splitlines()) == 1
    assert small == [0, 1, 2]
    cov = COVERAGE_LINE.search(err)
    assert cov and float(cov.group(1)) >= 0.98 and cov.group(2) == "2", err
    for segment in (*chip_smoke.BENCH_SEGMENTS, "sum"):
        assert sum(line.startswith(f"breakdown {segment}: ")
                   for line in err.splitlines()) == 1
    assert "breakdown failed" not in err
    assert "backend: cpu" in err and "compile+first: " in err
    assert re.search(r"^scene\+LUTs: [\d.]+s \(1260 tris\)$", err, re.M)
    profiled = "BENCH_STARTUP_PROFILE" in env
    assert ("startup: kernels+native build/load" in err) == profiled
    assert ("startup: warm-up+capture" in err) == profiled
    assert ("startup: first-replay" in err) == profiled


@pytest.mark.parametrize("fault", ["overflow", "coverage", "breakdown"])
def test_gates(fault, small, monkeypatch, capsys):
    """An overflow of 1 and a coverage of 0.5 each fail with bench.py's
    message and exit code 1, before any headline; a breakdown that raises
    prints 'breakdown failed' and keeps the headline."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.tools import bench

    render_frame = frame.render_frame

    def faulty(*a, **kw):
        color, state, aux = render_frame(*a, **kw)
        if fault == "overflow":
            aux = dict(aux, overflow=torch.ones((), dtype=torch.int32))
        if fault == "coverage":
            depth = state.prev_depth.clone()
            depth[: depth.shape[0] // 2] = 1.0
            state = state.replace(prev_depth=depth)
        return color, state, aux

    def broken(*a, **kw):
        raise RuntimeError("segment refused")

    monkeypatch.setattr(frame, "render_frame", faulty)
    monkeypatch.setattr(bench, "_breakdown", broken)
    monkeypatch.setenv("BENCH_FRAMES", "2")
    monkeypatch.setenv("BENCH_PIPELINE", "0")
    monkeypatch.setenv("BENCH_BREAKDOWN", "1")
    code = bench.main([])
    out, err = capsys.readouterr()
    if fault == "breakdown":
        assert code == 0
        _headline(out)
        assert "breakdown failed: RuntimeError('segment refused')" in err
        return
    assert code == 1 and out == ""
    if fault == "overflow":
        assert ("ERROR: raster bin overflow — 1 pairs dropped (geometry "
                "lost; raise pair_factor)") in err
        assert not COVERAGE_LINE.search(err)
    else:
        assert COVERAGE_LINE.search(err).group(1) == "0.500"
        assert ("ERROR: coverage 0.500 < 0.98 — bench workload regressed "
                "(camera left the enclosure?)") in err


def test_frames_in_flight_wait_on_the_previous_frame(small, monkeypatch,
                                                     capsys):
    """With frames in flight, frame i is dispatched before frame i-1's
    completion marker is waited on, and nothing else synchronises the
    timed loop: the order is dispatch 1, dispatch 2, wait 1, dispatch 3,
    wait 2, wait 3 (on the card the markers are CUDA events)."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.tools import bench
    from vkr_tpu_torch.tools import render as render_tool

    log = []
    render_frame = frame.render_frame

    class Marker:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            log.append(f"wait {self.i}")

    def logged(scene, state, *a, **kw):
        log.append(f"dispatch {int(state.frame_index)}")
        return render_frame(scene, state, *a, **kw)

    monkeypatch.setattr(frame, "render_frame", logged)
    monkeypatch.setattr(bench, "_frame_done",
                        lambda device: Marker(len(small) - 1))
    monkeypatch.setattr(render_tool, "synchronize",
                        lambda device: log.append("synchronize"))
    monkeypatch.setenv("BENCH_FRAMES", "4")
    monkeypatch.setenv("BENCH_BREAKDOWN", "0")
    assert bench.main([]) == 0
    _headline(capsys.readouterr()[0])
    timed = log[log.index("dispatch 1"):]
    assert timed == ["dispatch 1", "dispatch 2", "wait 1", "dispatch 3",
                     "wait 2", "wait 3"]


def test_needs_a_card_unless_asked(monkeypatch):
    """Without VKR_PLATFORM=cpu the bench runs on the card; without one
    it raises before building anything."""
    from vkr_tpu_torch.tools import bench

    _no_scene(monkeypatch)
    monkeypatch.delenv("VKR_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VKR_PLATFORM=cpu"):
        bench.main([])


def test_sponza_without_assets_raises(monkeypatch, capsys):
    """The default scene (sponza_tex) without VKR_ASSETS raises the scene
    layer's FileNotFoundError naming VKR_ASSETS; no colonnade is built in
    its place and nothing is printed on stdout."""
    from vkr_tpu_torch.scene import procedural
    from vkr_tpu_torch.tools import bench

    def refuse(**kw):
        raise AssertionError("the colonnade was built")

    monkeypatch.delenv("VKR_ASSETS", raising=False)
    monkeypatch.setattr(procedural, "colonnade_scene", refuse)
    with pytest.raises(FileNotFoundError, match="VKR_ASSETS"):
        bench.main([])
    assert capsys.readouterr()[0] == ""
