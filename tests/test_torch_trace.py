"""The trace (vkr_tpu_torch/core/graph.py): the registry's switch, reset
and snapshot; spans' parents, call ids and self time; add_task's spans
and profiler ranges; a captured frame's call spans and its pass spans
inside the replays (core/aot.py:CapturedFrame on fake graphs, the CPU
having none); the start-up spans of a small scene load."""

import json
import time

import numpy as np
import pytest
import torch

from vkr_tpu_torch.core import aot, graph

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_trace():
    """Each test starts and ends with the trace off and empty."""
    graph.trace_off()
    graph.trace_reset(startup=True)
    yield
    graph.trace_off()
    graph.trace_reset(startup=True)


def names(snap, clock=None):
    return [s["name"] for s in snap["spans"]
            if clock is None or s["clock"] == clock]


# ----------------------------------------------------------- the registry


def test_switch_reset_and_snapshot():
    """Off, a span and a counter record nothing; on, both are kept until
    trace_reset(), which keeps the start-up's, recorded on or off, until
    trace_reset(startup=True). The snapshot is a plain dict."""
    with graph.span("a"):
        graph.count("n")
    assert graph.trace_snapshot() == {"on": False, "counters": {},
                                      "spans": []}
    graph.trace_on()
    assert graph.tracing()
    with graph.span("a"):
        graph.count("n", 2)
    with graph.span("s", startup=True):
        graph.count("m", 3, startup=True)
    graph.count("m", 1)
    snap = graph.trace_snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap["on"] and names(snap) == ["a", "s"]
    assert snap["counters"] == {"n": 2, "m": 4}
    assert all(s["clock"] == "host" and s["end"] >= s["start"]
               for s in snap["spans"])
    graph.trace_reset()
    snap = graph.trace_snapshot()
    assert names(snap) == ["s"] and snap["counters"] == {"m": 3}
    graph.trace_off()
    with graph.span("s2", startup=True):
        graph.count("m", startup=True)
    with graph.span("b"):
        pass
    snap = graph.trace_snapshot()
    assert not snap["on"] and names(snap) == ["s", "s2"]
    assert snap["counters"] == {"m": 4}
    graph.trace_reset(startup=True)
    assert graph.trace_snapshot() == {"on": False, "counters": {},
                                      "spans": []}


def test_parent_call_id_and_self_time():
    """A span's parent is the innermost span open around it, and it takes
    that span's call id; self time is its seconds less its children's. A
    span with the trace off is not recorded."""
    graph.trace_on()
    call = graph.new_call()
    with graph.span("call", call=call) as outer:
        with graph.span("x"):
            with graph.span("y"):
                time.sleep(0.002)
        with graph.span("z"):
            pass
    with graph.span("free"):
        pass
    assert outer.call == call and outer.seconds > 0.002
    by = {s["name"]: s for s in graph.trace_snapshot()["spans"]}
    assert by["call"]["parent"] is None and by["free"]["parent"] is None
    assert by["x"]["parent"] == by["z"]["parent"] == by["call"]["id"]
    assert by["y"]["parent"] == by["x"]["id"]
    assert {by[n]["call"] for n in ("call", "x", "y", "z")} == {call}
    assert by["free"]["call"] is None
    assert by["y"]["seconds"] >= 0.002
    assert by["call"]["self"] == pytest.approx(
        by["call"]["seconds"] - by["x"]["seconds"] - by["z"]["seconds"],
        abs=1e-12)
    assert by["x"]["self"] == pytest.approx(
        by["x"]["seconds"] - by["y"]["seconds"], abs=1e-12)
    assert by["y"]["self"] == by["y"]["seconds"]
    assert graph.new_call() == call + 1

    graph.trace_off()
    graph.trace_reset()
    with graph.span("off") as off:
        pass
    assert off.id is None and off.call is None
    assert graph.trace_snapshot()["spans"] == []


def test_add_task_spans_and_profiler_ranges():
    """With the trace on a pass is a host span of its name and, under
    torch.profiler, a range vkr.<name> beside add_task's own range; with
    it off only add_task's range."""
    from torch.profiler import ProfilerActivity, profile

    graph.trace_on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = graph.add_task("GbufferPass", lambda t: t + 1, torch.zeros(4))
        with graph.span("call"):
            graph.add_task("TAA", lambda: None)
    assert torch.equal(out, torch.ones(4))
    seen = {e.name for e in prof.events()}
    assert {"GbufferPass", "vkr.GbufferPass", "TAA", "vkr.TAA",
            "vkr.call"} <= seen
    by = {s["name"]: s for s in graph.trace_snapshot()["spans"]}
    assert set(by) == {"GbufferPass", "call", "TAA"}
    assert by["TAA"]["parent"] == by["call"]["id"]
    assert by["GbufferPass"]["parent"] is None

    graph.trace_off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph.add_task("DeferedShading", lambda: None)
    seen = {e.name for e in prof.events()}
    assert "DeferedShading" in seen and "vkr.DeferedShading" not in seen


# ------------------------------------------------- the captured frame


class TimingEvent:
    """A fake graph's timing event: its time (seconds) is set at each
    replay of the graph it was recorded into."""

    def __init__(self):
        self.t = None
        self.waits = 0

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class FakeGraph:
    """A replay sets its events' times, the gap before event i being
    (i + 1) ms times the replay's number (1, 2, ... over all graphs), and
    runs the capture's host steps; it does not run the body again."""

    def __init__(self, graphs, events, steps):
        self.graphs, self.events, self.steps = graphs, events, steps

    def replay(self):
        self.graphs.replays += 1
        t = 100.0 * self.graphs.replays
        for i, ev in enumerate(self.events):
            t += (i + 1) * 1e-3 * self.graphs.replays
            ev.t = t
        for step in self.steps:
            step()


class FakeGraphs:
    """aot._CudaGraphs on the CPU: warm-up, capture (split at host steps),
    events, timing events, pinned memory."""

    device_type = "cpu"

    def __init__(self):
        self.replays = self.timing_events = 0

    def warm_up(self, run):
        return run()

    def capture(self, run):
        self._events, self._steps = [], []
        out = run()
        return FakeGraph(self, self._events, self._steps), out

    def split(self, step):
        self._steps.append(step)

    def event(self):
        return TimingEvent()

    def timing_event(self):
        self.timing_events += 1
        ev = TimingEvent()
        self._events.append(ev)
        return ev

    def pinned(self, n):
        return torch.zeros(n, dtype=torch.int32)

    def release(self):
        pass


def three_passes(x):
    """A, B, then A again: a pass that runs twice in a frame."""
    y = graph.add_task("A", lambda t: t + 1, x)
    y = graph.add_task("B", lambda t: t * 2, y)
    return graph.add_task("A", lambda t: t - 1, y)


def test_traced_capture_reads_pass_spans_per_replay():
    """A capture made with the trace on records a timing event before and
    after the graph and each pass (8 a graph, 16 for the two graphs).
    Each call waits for the replay two calls back, the last of the graph
    it replays, and records that replay's device spans under its call id
    and its host replay span: "replay" the whole graph, a span for each
    pass run. The events in the graph: begin, A, A, B, B, A, A, end;
    summed per pass, A is the gaps before events 2 and 6, B the gap
    before event 4; the rest of the replay lies outside the passes."""
    graph.trace_on()
    fake = FakeGraphs()
    frame = aot.CapturedFrame("traced", three_passes, graphs=fake)
    for _ in range(5):
        out = frame(torch.zeros(3))
    assert torch.equal(out, torch.ones(3))   # the capture's result
    assert fake.timing_events == 16 and fake.replays == 5
    snap = graph.trace_snapshot()
    host = [s for s in snap["spans"] if s["clock"] == "host"]
    calls = [s for s in host if s["name"] == "call"]
    assert len(calls) == 5
    replays = {s["call"]: s for s in host if s["name"] == "replay"}
    device = [s for s in snap["spans"] if s["clock"] == "device"]
    # calls 3, 4 and 5 read the replays of calls 1, 2 and 3
    read = [c["call"] for c in calls[:3]]
    assert [s["call"] for s in device if s["name"] == "replay"] == read
    for m, call in enumerate(read, start=1):
        mine = [s for s in device if s["call"] == call]
        root = [s for s in mine if s["name"] == "replay"]
        assert len(root) == 1 and root[0]["parent"] == replays[call]["id"]
        passes = [s for s in mine if s["name"] != "replay"]
        assert [s["name"] for s in passes] == ["A", "B", "A"]
        assert all(s["parent"] == root[0]["id"] for s in passes)
        per = {}
        for s in passes:
            per[s["name"]] = per.get(s["name"], 0.0) + s["seconds"]
        ms = 1e-3 * m
        assert per["A"] == pytest.approx((3 + 7) * ms)
        assert per["B"] == pytest.approx(5 * ms)
        assert root[0]["seconds"] == pytest.approx(sum(range(2, 9)) * ms)
        assert root[0]["self"] == pytest.approx(
            root[0]["seconds"] - per["A"] - per["B"])
    # the call spans' children: the capture in the first call, the reads
    # in calls 3-5
    for k, c in enumerate(calls):
        kids = [s["name"] for s in host if s["parent"] == c["id"]]
        assert kids == (["capture"] * (k == 0) + ["overflow_check", "load"]
                        + ["read_passes"] * (k >= 2) + ["replay"])


def test_untraced_capture_records_no_timing_event():
    """With the trace off at the capture the graphs get no timing event and
    the trace holds only the start-up's capture span, whose seconds are
    capture_seconds. Turned on later, the calls are spans, and there are
    no pass readings to read."""
    fake = FakeGraphs()
    frame = aot.CapturedFrame("plain", three_passes, graphs=fake)
    for _ in range(3):
        frame(torch.zeros(3))
    assert fake.timing_events == 0
    snap = graph.trace_snapshot()
    assert names(snap) == ["capture"]
    assert snap["spans"][0]["seconds"] == frame.capture_seconds > 0
    graph.trace_on()
    for _ in range(3):
        frame(torch.zeros(3))
    snap = graph.trace_snapshot()
    assert names(snap, "device") == []
    assert names(snap).count("call") == 3 and "read_passes" not in names(
        snap)
    assert fake.timing_events == 0


def test_host_steps_are_spans_of_step_seconds():
    """A host step is a host_step span inside its call's replay span, and
    step_seconds, the last call's host steps timed around their spans,
    holds them; with the trace off it is timed all the same and recorded
    nowhere."""

    def fn(x):
        y = graph.add_task("A", lambda t: t + 1, x)
        (y,) = aot.host_step(lambda t: (t * 2,), y)
        (y,) = aot.host_step(lambda t: (t + 3,), y)
        return graph.add_task("B", lambda t: t - 1, y)

    graph.trace_on()
    fake = FakeGraphs()
    frame = aot.CapturedFrame("steps", fn, graphs=fake)
    for _ in range(4):
        frame(torch.zeros(2))
    assert frame.host_steps == 2
    snap = graph.trace_snapshot()
    host = [s for s in snap["spans"] if s["clock"] == "host"]
    last = [s for s in host if s["name"] == "call"][-1]["call"]
    replay = [s for s in host if s["name"] == "replay"
              and s["call"] == last][0]
    steps = [s for s in host if s["name"] == "host_step"
             and s["call"] == last]
    assert len(steps) == 2
    assert all(s["parent"] == replay["id"] for s in steps)
    assert 0 < sum(s["seconds"] for s in steps) <= frame.step_seconds
    # the device spans: both passes, across the segments
    device = [s for s in snap["spans"] if s["clock"] == "device"]
    assert sorted({s["name"] for s in device}) == ["A", "B", "replay"]

    graph.trace_off()
    graph.trace_reset()
    frame(torch.zeros(2))
    assert frame.step_seconds > 0
    assert names(graph.trace_snapshot()) == ["capture"]


def test_summary_of_a_traced_capture():
    """trace_summary of the traced fake capture: per replay the means of
    replays 1-3 (m = 1, 2, 3 ms a gap unit: A 10m, B 5m, the replay 35m,
    20m of it outside the passes), per call the means of its steps over
    the five calls."""
    graph.trace_on()
    frame = aot.CapturedFrame("traced", three_passes, graphs=FakeGraphs())
    for _ in range(5):
        frame(torch.zeros(3))
    snap = graph.trace_snapshot()
    got = graph.trace_summary(snap)
    assert got["replays"] == 3 and got["calls"] == 5
    assert got["passes_ms"] == pytest.approx({"A": 20.0, "B": 10.0})
    assert got["replay_ms"] == pytest.approx(70.0)
    assert got["outside_ms"] == pytest.approx(40.0)
    host = [s for s in snap["spans"] if s["clock"] == "host"]
    replays = [s["seconds"] for s in host if s["name"] == "replay"]
    assert got["call_ms"]["replay"] == pytest.approx(
        1e3 * sum(replays) / 5)
    assert set(got["call_ms"]) == {"capture", "overflow_check", "load",
                                   "read_passes", "replay"}
    assert got["host_s"]["call"] == pytest.approx(
        sum(s["seconds"] for s in host if s["name"] == "call"))


def test_summary_sums_and_waits():
    """trace_summary on a snapshot written out by hand: a pass missing
    from a replay counts 0 there; only the waits under a call's
    overflow_check are its wait; a span inside one of the same name is
    not counted again; a mean over nothing is None."""
    def host(i, name, seconds, parent=None, call=None):
        return {"id": i, "name": name, "clock": "host", "start": 0.0,
                "end": seconds, "seconds": seconds, "self": seconds,
                "parent": parent, "call": call}

    def dev(i, name, seconds, parent, call, self_=None):
        return {"id": i, "name": name, "clock": "device", "start": 0.0,
                "end": seconds, "seconds": seconds,
                "self": seconds if self_ is None else self_,
                "parent": parent, "call": call}
    spans = [
        host(1, "decode", 0.5), host(2, "decode", 0.25, parent=1),
        host(3, "resize", 0.125), host(4, "decode", 1.0, parent=3),
        host(10, "call", 0.010, call=1),
        host(11, "overflow_check", 0.004, 10, 1),
        host(12, "wait", 0.003, 11, 1),
        host(13, "replay", 0.005, 10, 1),
        host(14, "wait", 0.002, 13, 1),
        host(20, "call", 0.020, call=2),
        host(21, "replay", 0.001, 20, 2),
        dev(30, "replay", 0.050, 13, 1, self_=0.010),
        dev(31, "A", 0.030, 30, 1), dev(32, "A", 0.005, 30, 1),
        dev(33, "B", 0.005, 30, 1),
        dev(40, "replay", 0.040, 21, 2, self_=0.020),
        dev(41, "A", 0.020, 40, 2),
    ]
    got = graph.trace_summary({"on": True, "counters": {}, "spans": spans})
    assert got["replays"] == 2 and got["calls"] == 2
    assert got["passes_ms"] == pytest.approx({"A": 27.5, "B": 2.5})
    assert got["replay_ms"] == pytest.approx(45.0)
    assert got["outside_ms"] == pytest.approx(15.0)
    assert got["call_ms"] == pytest.approx({"overflow_check": 2.0,
                                            "wait": 1.5, "replay": 3.0})
    assert got["host_s"]["decode"] == pytest.approx(1.5)
    assert got["host_s"]["resize"] == pytest.approx(0.125)
    assert got["host_s"]["wait"] == pytest.approx(0.005)
    empty = graph.trace_summary(graph.trace_snapshot())
    assert empty == {"replays": 0, "replay_ms": None, "passes_ms": {},
                     "outside_ms": None, "calls": 0, "call_ms": {},
                     "host_s": {}}


# ------------------------------------------------------------- start-up


def test_scene_load_spans(tmp_path, monkeypatch):
    """A small Sponza-layout texture set, a small colonnade and its upload,
    with the trace off: a decode and a resize span per image,
    decode.images and decode.bytes, the compile's resize and the upload
    span, summed by trace_summary. Bytes that are neither PNG nor JPEG
    raise and are not counted as decoded."""
    from vkr_tpu_torch.core.readback import png_bytes
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import gltf, procedural

    rng = np.random.default_rng(0)
    root = tmp_path / "Sponza" / "glTF"
    root.mkdir(parents=True)
    files = []
    for i, (h, w) in enumerate(((16, 8), (8, 8))):
        data = png_bytes(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
        (root / f"t{i}.png").write_bytes(data)
        files.append(len(data))
    (root / "Sponza.gltf").write_text(json.dumps({
        "images": [{"uri": "t0.png"}, {"uri": "t1.png"}],
        "textures": [{"source": 0}, {"source": 1}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1}}}]}))
    monkeypatch.setenv("VKR_ASSETS", str(tmp_path))
    monkeypatch.setenv("VKR_DISK_CACHE", "0")

    _, images, _, _ = procedural.sponza_texture_set(8)
    assert [im.shape for im in images] == [(8, 8, 4)] * 2
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        gltf._decode_image(b"GIF89a..")
    snap = graph.trace_snapshot()
    assert names(snap) == ["decode", "resize"] * 2 + ["decode"]
    assert snap["counters"] == {"decode.images": 2,
                                "decode.bytes": sum(files)}

    graph.trace_reset()      # the trace's only: start-up spans stay
    scene_cpu = procedural.colonnade_scene(columns=3, tessellation=2,
                                           tex_size=8)
    upload_scene(scene_cpu, "cpu")
    snap = graph.trace_snapshot()
    assert names(snap)[5:] == ["resize", "upload"]
    got = graph.trace_summary(snap)["host_s"]
    for name in ("decode", "resize", "upload"):
        assert got[name] == pytest.approx(sum(
            s["seconds"] for s in snap["spans"] if s["name"] == name))
