"""The readers of the program's start-up spans (texture_decode_s,
texture_resize_s, scene_upload_s): against a trace written out by hand,
without one, against a program that has no trace, and in a tiny traced
run on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import types

import pytest

import bench_helpers
from harness import spec

READERS = {"texture_decode_s": "decode", "texture_resize_s": "resize",
           "scene_upload_s": "upload"}


def host(i, name, seconds, parent=None):
    return {"id": i, "name": name, "clock": "host", "start": 0.0,
            "end": seconds, "seconds": seconds, "self": seconds,
            "parent": parent, "call": None}


@pytest.fixture
def empty_trace():
    """The process's trace off and empty, before and after."""
    from vkr_tpu_torch.core import graph

    graph.trace_off()
    graph.trace_reset(startup=True)
    yield graph
    graph.trace_reset(startup=True)


def test_readers_sum_their_spans(empty_trace):
    """Each reader sums the spans of its name in ctx.program_trace, a span
    inside one of the same name counted once."""
    snap = {"on": False, "counters": {"decode.images": 2}, "spans": [
        host(1, "decode", 0.5), host(2, "decode", 0.25),
        host(3, "resize", 0.125), host(4, "resize", 0.0625, parent=3),
        host(5, "resize", 0.03125), host(6, "upload", 2.0),
        host(7, "decode", 1.0, parent=6)]}
    ctx = types.SimpleNamespace(program_trace=snap)
    got = {m: spec.load_reader(m, bench_helpers.ROOT)(ctx) for m in READERS}
    assert got == pytest.approx({"texture_decode_s": 1.75,
                                 "texture_resize_s": 0.15625,
                                 "scene_upload_s": 2.0})


def test_readers_without_spans_return_none(empty_trace, monkeypatch):
    """No ctx.program_trace and nothing recorded in the process, or a
    program without the trace (the parent of the readers): None."""
    graph = empty_trace
    ctx = types.SimpleNamespace()
    for m in READERS:
        assert spec.load_reader(m, bench_helpers.ROOT)(ctx) is None
    with graph.span("upload", startup=True):
        pass
    ctx = types.SimpleNamespace()
    read = spec.load_reader("scene_upload_s", bench_helpers.ROOT)
    assert read(ctx) > 0
    monkeypatch.delattr(graph, "trace_summary")
    for m in READERS:
        assert spec.load_reader(m, bench_helpers.ROOT)(ctx) is None


@pytest.mark.parametrize("workload,expect", [
    ("sponza_orbit", set(READERS)),
    ("rt_orbit", {"scene_upload_s"})])
def test_traced_run_prints_the_startup_metrics(tmp_path, empty_trace,
                                               workload, expect):
    """A tiny --trace 1 run on the CPU prints the readers its cell lists,
    each a positive number of seconds below the run's set-up."""
    import run

    root = bench_helpers.tiny_root(str(tmp_path))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "3100000411",
                       "--seconds", "1", "--trace", "1"], device="cpu",
                      root=root)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    got = {m: v["value"] for m, v in line["metrics"].items()
           if m in READERS}
    assert set(got) == expect
    assert all(0 < v < line["metrics"]["scene_load_s"]["value"]
               for v in got.values())
