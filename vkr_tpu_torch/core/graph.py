"""Pass-DAG orchestration — the rendergraph analog, as vkr_tpu/core/graph.py
has it — and the process's trace.

The reference rendergraph (src/rendergraph/rendergraph.{hpp,cpp}) computes
barriers and layouts between tasks recorded into one command buffer. Here
the frame is a chain of PyTorch calls on one stream, which orders them, so
the barrier engine dissolves. What stays:
  * task naming: each pass runs under torch.profiler.record_function with
    the reference's task name (GbufferPass, SSSR_trace, GTAO_main, ...),
    and under an NVTX range of that name once CUDA is in use, so profiles
    carry the reference's debug labels (rendergraph.cpp:289-305);
  * the structural dump, the analog of the reference's barrier printer
    (resources.cpp:483-634): a record of each task's inputs and outputs,
    printed for inspection or held in tests.

The trace (below) holds spans and counters in memory. It is off until
trace_on(); trace_snapshot() writes it out as a plain dict. A span has a
name, a start and an end, the span it ran inside (its parent) and the id
of the captured-frame call it belongs to (core/aot.py:CapturedFrame).
Host spans are timed by the host's clock: add_task's passes, a call's
steps, and the start-up's scene loading, which is recorded with the trace
on or off. Device spans are the passes inside a captured frame's replay,
timed by events that a traced capture records into the graph
(PassMarks).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PassRecord:
    name: str
    inputs: List[str]
    outputs: List[str]


def _leaves(tree: Any) -> List[Any]:
    """The leaves of a nest of tuples, NamedTuples, lists, dicts (sorted by
    key) and dataclasses, in jax.tree_util.tree_leaves' order; None is an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaves(getattr(tree, f.name))]
    return [tree]


def _dtype_name(leaf: Any) -> str:
    """numpy's name for a leaf's type: float32, bool, ... (int and float
    for Python scalars, as vkr_tpu prints them)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return str(leaf.dtype)
    return type(leaf).__name__


def _describe(tree: Any) -> List[str]:
    return [f"{_dtype_name(leaf)}{list(getattr(leaf, 'shape', ()))}"
            for leaf in _leaves(tree)]


class PassGraph:
    """Records the pass structure of a frame while the frame runs.

    Usage:
        graph = PassGraph()
        with graph.recording():
            out = render_frame(...)   # passes call add_task(...)
        print(graph.dump())
    """

    _active: Optional["PassGraph"] = None

    def __init__(self) -> None:
        self.records: List[PassRecord] = []

    @contextlib.contextmanager
    def recording(self):
        prev, PassGraph._active = PassGraph._active, self
        try:
            yield self
        finally:
            PassGraph._active = prev

    def dump(self) -> str:
        """Human-readable DAG dump (analog of the reference's barrier dump,
        printed for the first frames at rendergraph.cpp:272-280)."""
        lines = ["=== pass DAG ==="]
        for i, r in enumerate(self.records):
            lines.append(f"[{i:2d}] {r.name}")
            lines.append(f"      in : {', '.join(r.inputs) or '-'}")
            lines.append(f"      out: {', '.join(r.outputs) or '-'}")
        return "\n".join(lines)


# ---------------------------------------------------------------- tracing

SPAN_LIMIT = 1 << 16     # spans the trace keeps; the oldest go first
STARTUP_LIMIT = 1 << 12  # start-up spans kept, likewise


class Trace:
    """The process's spans and counters, in memory.

    `spans` and `counters` hold what was recorded while the trace was on
    (trace_reset() forgets them); `startup` and `startup_counters` what
    start-up records whether it is on or not (scene loading, captures),
    forgotten only by trace_reset(startup=True). A span is kept as
    (id, name, clock, start, end, parent id, call id): clock "host" times
    in perf_counter seconds, clock "device" in seconds from the start of
    its replay."""

    def __init__(self) -> None:
        self.on = False
        self.spans: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
        self.startup: collections.deque = collections.deque(
            maxlen=STARTUP_LIMIT)
        self.counters: Dict[str, float] = {}
        self.startup_counters: Dict[str, float] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.calls = itertools.count(1)


TRACE = Trace()
# (id, call id) of the innermost open span of this thread
_OPEN = contextvars.ContextVar("vkr_trace_open", default=(None, None))
# the PassMarks of the traced capture running, if any
_MARKS = contextvars.ContextVar("vkr_pass_marks", default=None)


def trace_on() -> None:
    TRACE.on = True


def trace_off() -> None:
    TRACE.on = False


def tracing() -> bool:
    return TRACE.on


def trace_reset(startup: bool = False) -> None:
    """Forget the spans and counters the trace recorded; with startup,
    the start-up's too."""
    with TRACE.lock:
        TRACE.spans.clear()
        TRACE.counters.clear()
        if startup:
            TRACE.startup.clear()
            TRACE.startup_counters.clear()


def trace_snapshot() -> dict:
    """The trace as a plain dict: "on"; "spans", start-up's and the
    trace's by id (a host span takes its id when it opens, a device span
    when it is read), each {id, name, clock, start, end, seconds, self,
    parent, call}, where self is seconds less the seconds of its children
    on the same clock; "counters", start-up's and the trace's summed."""
    with TRACE.lock:
        rows = sorted([*TRACE.startup, *TRACE.spans])
        counters = dict(TRACE.startup_counters)
        for name, n in TRACE.counters.items():
            counters[name] = counters.get(name, 0) + n
    children: Dict[Any, float] = {}
    for _, _, clock, start, end, parent, _ in rows:
        if parent is not None:
            children[parent, clock] = (children.get((parent, clock), 0.0)
                                       + end - start)
    return {"on": TRACE.on, "counters": counters, "spans": [
        {"id": i, "name": name, "clock": clock, "start": start, "end": end,
         "seconds": end - start,
         "self": end - start - children.get((i, clock), 0.0),
         "parent": parent, "call": call}
        for i, name, clock, start, end, parent, call in rows]}


def trace_summary(snap: dict) -> dict:
    """A trace_snapshot() per replay, per call and in all:

      replays     the replays read (device "replay" spans);
      replay_ms   their mean device time;
      passes_ms   {pass: the mean over those replays of its device time},
                  a pass that runs several times in a frame summed, and
                  0 in a replay without it;
      outside_ms  the mean device time of a replay that no pass covers
                  (the replay span's self time);
      calls       the "call" spans;
      call_ms     {name: the mean over the calls of a call's child spans
                  of that name summed}, and "wait": the time its
                  overflow_check blocked on the device;
      host_s      {name: the seconds of the host spans of that name
                  summed}, a span inside one of the same name not counted
                  again (the start-up's decode, resize, upload, capture).

    Times in ms but host_s; a mean over nothing is None."""
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}

    def summed(parents, pick):
        out = {p: {} for p in parents}
        for s in spans:
            key = pick(s)
            if key in out:
                out[key][s["name"]] = out[key].get(s["name"], 0.0) \
                    + s["seconds"]
        return list(out.values())

    def mean_ms(xs):
        xs = list(xs)
        return 1e3 * sum(xs) / len(xs) if xs else None

    replays = [s for s in spans
               if s["clock"] == "device" and s["name"] == "replay"]
    per_replay = summed([r["id"] for r in replays],
                        lambda s: s["parent"] if s["clock"] == "device"
                        else None)
    calls = [s["id"] for s in spans
             if s["clock"] == "host" and s["name"] == "call"]
    checks = {s["id"]: s["parent"] for s in spans
              if s["name"] == "overflow_check"}
    per_call = summed(calls, lambda s: (
        checks.get(s["parent"]) if s["name"] == "wait"
        else s["parent"] if s["clock"] == "host" else None))
    host_s: Dict[str, float] = {}
    for s in spans:
        if s["clock"] != "host":
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] != s["name"]:
            up = by_id.get(up["parent"])
        if up is None:
            host_s[s["name"]] = host_s.get(s["name"], 0.0) + s["seconds"]
    return {
        "replays": len(replays),
        "replay_ms": mean_ms(r["seconds"] for r in replays),
        "passes_ms": {n: mean_ms(d.get(n, 0.0) for d in per_replay)
                      for n in sorted({n for d in per_replay for n in d})},
        "outside_ms": mean_ms(r["self"] for r in replays),
        "calls": len(calls),
        "call_ms": {n: mean_ms(d.get(n, 0.0) for d in per_call)
                    for n in sorted({n for d in per_call for n in d})},
        "host_s": host_s,
    }


def new_call() -> int:
    """A new call id: the identifier a captured-frame call's spans share."""
    return next(TRACE.calls)


def count(name: str, n: float = 1, *, startup: bool = False) -> None:
    """Add n to a counter: the trace's while it is on, start-up's always
    with startup."""
    if not (startup or TRACE.on):
        return
    with TRACE.lock:
        store = TRACE.startup_counters if startup else TRACE.counters
        store[name] = store.get(name, 0) + n


def device_span(name: str, start: float, end: float, parent, call):
    """Record a device reading (seconds from its replay's start) while the
    trace is on; its id, else None."""
    if not TRACE.on:
        return None
    i = next(TRACE.ids)
    with TRACE.lock:
        TRACE.spans.append((i, name, "device", start, end, parent, call))
    return i


class _Span:
    """A recorded host span (span()); `seconds` once it has ended."""

    __slots__ = ("name", "store", "call", "id", "parent", "start", "end",
                 "_token", "_range")

    def __init__(self, name, store, call):
        self.name, self.store, self.call = name, store, call
        self.id = self.parent = self._token = self._range = None
        self.start = self.end = None

    def __enter__(self):
        self.parent, call = _OPEN.get()
        if self.call is None:
            self.call = call
        self.id = next(TRACE.ids)
        self._token = _OPEN.set((self.id, self.call))
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(f"vkr.{self.name}")
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        _OPEN.reset(self._token)
        with TRACE.lock:
            self.store.append((self.id, self.name, "host", self.start,
                               self.end, self.parent, self.call))
        return False

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _Off:
    """span() where nothing is recorded."""

    id = call = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, *, call: Optional[int] = None, startup: bool = False):
    """A context manager timing a host span named `name`, inside the
    innermost open one (its parent, whose call id it takes unless `call`
    gives one). Recorded while the trace is on, or always with startup
    (start-up's spans); else it does nothing. While torch.profiler
    records, a recorded span is also a record_function range named
    vkr.<name>, on the profiler's clock."""
    store = TRACE.startup if startup else TRACE.spans if TRACE.on else None
    return _OFF if store is None else _Span(name, store, call)


class PassMarks:
    """The timing events of one traced capture (CapturedFrame): `begin`
    and `end` around the whole graph, and a pair around each pass that
    add_task runs while marking(self) is in force. The graph replays them
    with its work; read() turns the last replay's into device spans.
    event: () -> an event recorded on the current stream (under a capture,
    a node of the graph)."""

    def __init__(self, event: Callable) -> None:
        self.event = event
        self.begin = self.end = None
        self.passes: List[list] = []   # [name, start event, end event]

    def whole(self, fn: Callable):
        """fn() between `begin` and `end`: the graph's own device time."""
        self.begin = self.event()
        out = fn()
        self.end = self.event()
        return out

    def around(self, name: str, fn: Callable, args, kwargs):
        """fn(*args, **kwargs) between a pass's two events."""
        marks = [name, self.event(), None]
        out = fn(*args, **kwargs)
        marks[2] = self.event()
        self.passes.append(marks)
        return out

    def read(self, parent, call) -> None:
        """Wait for the last replay's end event, then record its device
        spans under `parent` (the host span that launched it) and `call`:
        "replay", the graph from begin to end, and inside it a span for
        each pass run (a pass that runs several times in a frame has one
        for each)."""
        self.end.synchronize()

        def at(ev):
            return self.begin.elapsed_time(ev) * 1e-3
        root = device_span("replay", 0.0, at(self.end), parent, call)
        for name, start, end in self.passes:
            device_span(name, at(start), at(end), root, call)


@contextlib.contextmanager
def marking(marks: Optional[PassMarks]):
    """add_task marks its passes with `marks` (None: not) in the block."""
    token = _MARKS.set(marks)
    try:
        yield marks
    finally:
        _MARKS.reset(token)


def _nvtx(name: str):
    """An NVTX range once CUDA is in use in this process, else nothing."""
    if torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


def add_task(name: str, fn: Callable, *args: Any, **kwargs: Any):
    """Run `fn` under the task's name, recording it if a PassGraph records.

    The analog of RenderGraph::add_task (rendergraph.hpp:116-128): there is
    no declare/execute split, because there are no barriers to compute; the
    declared accesses are the function's arguments and results. With no
    graph recording this adds no host synchronisation and no device copy
    (a record reads shapes and dtypes only). While the trace is on the
    pass is a host span of its name, and inside a traced capture also a
    pair of timing events in the graph (PassMarks)."""
    marks = _MARKS.get()
    with torch.profiler.record_function(name), _nvtx(name), span(name):
        out = (fn(*args, **kwargs) if marks is None
               else marks.around(name, fn, args, kwargs))
    graph = PassGraph._active
    if graph is not None:
        graph.records.append(
            PassRecord(name, _describe((args, kwargs)), _describe(out)))
    return out
