"""The traced frame, under vkr_tpu's name: cached_jit.

vkr_tpu traces the whole frame once under jax.jit, keeps the trace on
disk (jax.export) so that a later process skips Python tracing, and
replays one compiled executable per frame with the FrameState donated
(vkr_tpu/core/aot.py; bench.py:215-244, tools/render.py:138). The port's
counterpart of that executable is a CUDA graph: cached_jit records fn
once and replays the recording at every later call, so that a frame costs
one graph launch of host time and no launch from Python.

On CUDA arguments cached_jit returns a CapturedFrame (below), for every
frame: the ray-traced GTAO frame too, whose any-hit walk is a kernel of
fixed shape on the card (csrc/ray_any_hit.cu). On CPU arguments it
returns fn itself: the kernels' plain versions are the CPU's path, and
the CPU has no graph.

A frame that runs on several ranks (parallel/band.py, parallel/sharding.py)
is captured the same way. Its gathers under gloo stage through host memory,
which a graph cannot hold: each is a host step (host_step below), where
the capture ends one graph and begins the next, so the frame is a list of
graphs (segments) replayed in order with the host steps between them.
Under NCCL (a card per rank) the collectives are recorded into the graph,
and the frame is one segment.

What a process builds before its first frame, and keeps on disk for the
next, is the hand-written CUDA kernels (kernels.build(): nvcc into build/,
keyed by each source's hash) and the native asset pipeline
(native.build()). cached_jit builds and loads both when its example
arguments live on the card; VKR_AOT=0 skips that, as it skips vkr_tpu's
export, and the frame is captured all the same (vkr_tpu's VKR_AOT=0 still
jits).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import os
import sys
import time
from typing import Callable

import torch

from vkr_tpu_torch.core import registry
from vkr_tpu_torch.core.graph import (
    PassMarks, _leaves, marking, new_call, span, tracing)

# A non-donated tensor argument of at most this many bytes (a camera
# matrix, a jitter, a transform table) is copied into a buffer of the
# graph's own before each replay; a larger one (a scene's vertices and
# textures, a LUT, a probe grid) is read in place.
INPUT_BYTES = 1 << 16
# Overflow readings kept in pinned memory for replays not yet checked.
OVERFLOW_RING = 8

# What a CapturedFrame records while fn runs in its warm-up or capture
# (_WarmUp, _Capture); None while fn runs eagerly.
_RECORDING = contextvars.ContextVar("vkr_aot_recording", default=None)


def host_step(fn: Callable, *tensors):
    """fn(*tensors) as a step on the host between two graphs of a captured
    frame. fn returns a tuple of tensors and may do what a CUDA graph
    cannot hold: read the host, run a gloo collective
    (parallel/band.py:RowGather).

    Eagerly, and in a CapturedFrame's warm-up, this is fn(*tensors); the
    warm-up records the shapes and dtypes of its results, step by step.
    While a CapturedFrame captures, the graph being recorded (a segment)
    ends here, the step returns static tensors of the warm-up's shapes,
    unwritten, and the next segment begins in the same pool and on the
    same stream. At each replay, once the segment before the step has
    completed, fn runs on the same tensors (what that segment wrote) and
    its results are copied into the static tensors before the next
    segment is replayed."""
    rec = _RECORDING.get()
    return fn(*tensors) if rec is None else rec.step(fn, tensors)


def collective():
    """Tell the CapturedFrame that is warming up fn, if any, that fn runs a
    collective (parallel/band.py:RowGather calls this). Its overflow is
    then a reading every rank shares, and each call waits for the
    previous call's reading before deciding on it, so that every rank
    raises BinOverflow, and call_or_recapture captures anew, at the same
    call (else one rank would replay into a collective the others never
    join)."""
    rec = _RECORDING.get()
    if rec is not None:
        rec.collective = True


def capturing() -> bool:
    """True while fn runs in a CapturedFrame's warm-up or capture."""
    return _RECORDING.get() is not None


@contextlib.contextmanager
def _recording(rec):
    token = _RECORDING.set(rec)
    try:
        yield rec
    finally:
        _RECORDING.reset(token)


class _Spec:
    """The shape, dtype and device of a host step's result in the
    warm-up: the static tensor a capture allocates in its place."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype, self.device = t.shape, t.dtype, t.device

    def empty(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)


class _WarmUp:
    """The warm-up's record: each host step's results as _Specs, in order,
    and whether fn runs a collective."""

    def __init__(self, name):
        self.name, self.specs, self.collective = name, [], False

    def step(self, fn, tensors):
        out = fn(*tensors)
        if not (isinstance(out, tuple) and all(
                isinstance(t, torch.Tensor) for t in out)):
            raise TypeError(f"cached_jit: {self.name}: host step "
                            f"{len(self.specs)} returned a "
                            f"{type(out).__name__}, not a tuple of tensors")
        self.specs.append(tuple(_Spec(t) for t in out))
        return out


class _HostStep:
    """A host step of a capture: fn, the tensors it reads (the segment
    before it wrote them) and the static tensors it fills (the segment
    after it reads them). Calling it runs fn and copies its results in,
    a host_step span, adding its host seconds to the frame's
    step_seconds."""

    def __init__(self, frame, fn, inputs, outputs):
        self.frame, self.fn = frame, fn
        self.inputs, self.outputs = inputs, outputs

    def __call__(self):
        t0 = time.perf_counter()
        with span("host_step"):
            for dst, src in zip(self.outputs, self.fn(*self.inputs)):
                dst.copy_(src)
        self.frame.step_seconds += time.perf_counter() - t0


class _Capture:
    """A capture's record: at each host step the graphs end a segment and
    begin the next (graphs.split), and the step's static results are
    allocated there, in the new segment's pool."""

    def __init__(self, frame, graphs, specs):
        self.frame, self.graphs, self.specs = frame, graphs, specs
        self.steps, self.collective = [], False

    def step(self, fn, tensors):
        k = len(self.steps)
        if k == len(self.specs):
            raise RuntimeError(f"cached_jit: {self.frame.name}: the capture "
                               f"makes more host steps than its warm-up "
                               f"({k})")
        step = _HostStep(self.frame, fn, tensors, None)
        self.graphs.split(step)
        step.outputs = tuple(s.empty() for s in self.specs[k])
        self.steps.append(step)
        return step.outputs


def cached_jit(name: str, fn: Callable, example_args, *, donate_argnums=(),
               cache_dir: str | None = None, verbose: bool = False,
               extra_key: str = "") -> Callable:
    """fn as a captured frame when example_args hold a CUDA tensor, else fn.

    vkr_tpu's signature (vkr_tpu/core/aot.py:104). With a CUDA tensor
    among example_args the CUDA kernel libraries and the native asset
    pipeline are built (if their hashed files are missing) and loaded,
    unless VKR_AOT=0; with verbose, the seconds go to stderr under `name`.
    donate_argnums: at most one argument, the FrameState, which the
    captured frame takes over (CapturedFrame). cache_dir and extra_key
    place and key vkr_tpu's serialised trace; a graph lives in its
    process, and the builds are keyed by their sources
    (kernels.library_path, native.library_path), so both are accepted and
    not used. The result is tracked with registry.track_jit, so reload()
    and clear_jit_caches() drop its graphs."""
    del cache_dir, extra_key
    if not any(getattr(leaf, "is_cuda", False)
               for leaf in _leaves(example_args)):
        return fn
    if os.environ.get("VKR_AOT", "1") == "1":
        from vkr_tpu_torch import kernels, native

        t0 = time.perf_counter()
        kernels.build()
        for lib in kernels.SOURCES:
            kernels.library(lib)
        t1 = time.perf_counter()
        native.load()
        if verbose:
            print(f"aot: {name}: CUDA kernels ({', '.join(kernels.SOURCES)})"
                  f" built and loaded in {t1 - t0:.2f} s, native asset "
                  f"pipeline in {time.perf_counter() - t1:.2f} s",
                  file=sys.stderr, flush=True)
    return registry.track_jit(CapturedFrame(
        name, fn, donate_argnums=donate_argnums, verbose=verbose))


class BinOverflow(RuntimeError):
    """A replay of a CapturedFrame dropped bin pairs: its frame binned more
    pairs than the capture frame's counts times PAIR_HEADROOM. Raised at a
    later call, before that call replays anything; `call` is the number of
    the replay that dropped them, `dropped` how many. A tool goes on with
    call_or_recapture, as vkr_tpu's tools render on past an overflow."""

    def __init__(self, message, call, dropped):
        super().__init__(message)
        self.call = call
        self.dropped = dropped


def call_or_recapture(frame, *args):
    """frame(*args), as the tools call their captured frame: on a
    BinOverflow the capture is dropped (cache_clear, which frees its
    pools) and made anew at this call, on these arguments, the current
    view. The donated state carries over: the state the last replay
    returned is copied before the old pools go, and the copy is the new
    capture's example state. An uncaptured frame (cached_jit's fn on the
    CPU) is called as it is."""
    try:
        return frame(*args)
    except BinOverflow as err:
        args = list(args)
        for i in frame.donated:
            args[i] = _map(args[i], torch.clone)
        frame.cache_clear()
        print(f"{err}; captured anew at the next view", file=sys.stderr,
              flush=True)
        return frame(*args)


def _map(tree, f):
    """tree with every leaf replaced by f(leaf), in _leaves' traversal
    (tuples, NamedTuples, lists, dicts, dataclasses; None is a leaf)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(t, f) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(t, f) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(tree[k], f) for k in sorted(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            fl.name: _map(getattr(tree, fl.name), f)
            for fl in dataclasses.fields(tree)})
    return f(tree)


def _flat(tree) -> list:
    out = []
    _map(tree, out.append)
    return out


def _find_overflow(tree):
    """The first tensor under a dict key or NamedTuple field "overflow"."""
    if isinstance(tree, dict):
        if isinstance(tree.get("overflow"), torch.Tensor):
            return tree["overflow"]
        items = [tree[k] for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if isinstance(getattr(tree, "overflow", None), torch.Tensor):
            return tree.overflow
        items = list(tree)
    elif isinstance(tree, (list, tuple)):
        items = list(tree)
    else:
        return None
    for t in items:
        found = _find_overflow(t)
        if found is not None:
            return found
    return None


class _Segments:
    """A captured frame's graph: the CUDA graphs of its segments, replayed
    in capture order, and between each two the host step (_HostStep) that
    split them, run once the segment before it has completed. A frame with
    no host step is one segment."""

    def __init__(self, keep_graph: bool):
        self.keep_graph = keep_graph
        self.graphs, self.steps = [], []

    def begin(self):
        """Begin recording the next segment on the current stream, in the
        first segment's pool (a new private pool for the first)."""
        graph = torch.cuda.CUDAGraph(
            **({"keep_graph": True} if self.keep_graph else {}))
        graph.capture_begin(pool=self.graphs[0].pool() if self.graphs
                            else None)
        self.graphs.append(graph)

    def replay(self):
        for graph, step in itertools.zip_longest(self.graphs, self.steps):
            graph.replay()
            if step is not None:
                with span("wait"):
                    torch.cuda.current_stream().synchronize()
                step()


class _CudaGraphs:
    """What CapturedFrame asks of CUDA: a warm-up on a side stream, the
    capture of a graph (its own memory pool) in segments, events, pinned
    memory. keep_graph: keep each segment's cudaGraph_t
    (CUDAGraph(keep_graph=True)), for a count of its nodes."""

    device_type = "cuda"

    def __init__(self, keep_graph: bool = False):
        self.keep_graph = keep_graph
        self._open = None

    @staticmethod
    def warm_up(run):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = run()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, run):
        """(graph, run's result recorded into it); graph.replay() reruns it.
        As torch.cuda.graph records one graph (a synchronize and an
        empty_cache first, then a side stream and a private pool), except
        that run may call split() at a host step."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self._open = _Segments(self.keep_graph)
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                self._open.begin()
                try:
                    out = run()
                finally:
                    self._open.graphs[-1].capture_end()
            return self._open, out
        finally:
            self._open = None

    def split(self, step):
        """End the segment being recorded, to be followed at replay by
        step, and begin the next in the same pool on the same stream (the
        torch.cuda.graph context manager cannot be split)."""
        self._open.graphs[-1].capture_end()
        self._open.steps.append(step)
        self._open.begin()

    @staticmethod
    def event():
        """An event recorded on the current stream."""
        done = torch.cuda.Event()
        done.record()
        return done

    @staticmethod
    def timing_event():
        """A timing event recorded on the current stream; under a capture
        an event-record node of the graph (external), recorded again at
        each replay."""
        done = torch.cuda.Event(enable_timing=True, external=True)
        done.record()
        return done

    @staticmethod
    def pinned(n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int32, pin_memory=True)

    @staticmethod
    def release():
        """Return the pools of dropped graphs to the device: a graph's
        private pool is freed only by empty_cache(), and no other
        allocation can use it meanwhile."""
        torch.cuda.empty_cache()


class CapturedFrame:
    """fn recorded into two CUDA graphs at its first call and replayed at
    every call, in turns (cached_jit's result on CUDA arguments).

    First call: a warm-up run of fn on a side stream (every library, lazily
    loaded CUDA module, cached constant and allocator pool is made there,
    and the binning records each raster call's exact pair count), then two
    captures of fn with the binning at static capacities (the capture
    frame's counts, raster/setup.py:static_capacities), then the first
    replay. Nothing on CUDA runs fn eagerly after that, and a capture or
    replay that fails raises.

    Arguments. The donated one (donate_argnums, the FrameState) lives in two
    sets of buffers: graph 0 reads set 0 and leaves the new state in set 1,
    graph 1 the other way round, so the state a call returns is the one
    the next call reads, and the call after that overwrites it, as
    donation allows. The new state's tensors come from the graph's own
    pool, where the allocator places them, so the graph's last step copies
    them into the other set (~48 MB at 1080p; the allocator cannot be asked
    to place them in that set). A state that is not the one the last call
    returned (the first, a loaded checkpoint) is copied into the set the
    next graph reads. A non-donated tensor of at most INPUT_BYTES (the
    CameraFrame) is copied into a buffer of the graphs' before each replay;
    a larger one (the scene, the SSR resources, the probe grid) is read in
    place and must be the same object at every call: changing it means a
    new cached_jit. Other values (ints, floats, None) are recorded as
    they are and must be equal at every call.

    Results. Each graph has its own memory pool, so the colour and aux of a
    call stay as they are through the next call, which replays the other
    graph; the call after that overwrites them.

    Segments. A graph is the list of segments its capture split at fn's
    host steps (host_step, a gloo gather of the band frame), all in its
    pool: `segments` per graph and `host_steps` count them (a frame
    without host steps is one segment), and `step_seconds` is the host
    time of the last call's host steps (each a host_step span), each
    timed from the completion of the segment before it to the end of its
    copies. `launches` counts the kernels of all segments.

    Trace (core/graph.py). The warm-up and captures are a start-up span,
    "capture", whose seconds are `capture_seconds`. While the trace is on
    a call is a span "call" with a new call id, and its children
    "overflow_check" (with a "wait" for each time it blocks on the
    device), "load", "replay" (the launches, and a "host_step" for each
    host step). A capture made while the trace is on puts a pair of
    timing events around the graph and around each pass (add_task) into
    both graphs (PassMarks); a traced call then first waits for the last
    replay of the graph it is about to replay, two calls back, and
    records that replay's device spans ("replay" and the passes, under
    the call id of that replay). A capture made with the trace off has no
    node more.

    Overflow is never silent: after each replay the frame's overflow
    (the dropped bin pairs under a dict key or field "overflow") is copied
    without waiting into pinned memory, and each later call reads the
    readings whose replay has completed and raises BinOverflow on one that
    is not 0, naming the call and the count (call_or_recapture goes on
    from it). A frame that runs a collective (`collective`, see
    collective()) waits at each call for the previous call's reading, so
    that every rank decides at the same call. The caller reads the last
    frame's aux["overflow"] itself, as with the eager frame.

    cache_clear() (registry.clear_jit_caches(), reload()) drops the graphs;
    the next call captures anew (`captures` counts the captures made).
    graphs: the CUDA side (_CudaGraphs), which a test replaces with a
    fake."""

    def __init__(self, name, fn, *, donate_argnums=(), verbose=False,
                 graphs=None):
        if len(tuple(donate_argnums)) > 1:
            raise NotImplementedError(
                f"cached_jit: {name}: at most one donated argument")
        self.name = name
        self.fn = fn
        self.donated = tuple(donate_argnums)
        self.verbose = verbose
        self.graphs = graphs or _CudaGraphs()
        self.capture_seconds = None
        self.capacities = None
        self.launches = None
        self.segments = self.host_steps = None
        self.collective = False
        self.step_seconds = 0.0
        self.calls = 0
        self.captures = 0
        self.cache_clear()

    def cache_clear(self):
        """Drop the graphs, their pools and buffers; the pools go back to
        the device (graphs.release())."""
        held = getattr(self, "_slots", None) is not None
        self._slots = self._sets = self._inputs = self._ring = None
        self._returned = None
        self._marks = [None, None]     # graph g's PassMarks, if traced
        self._unread = [None, None]    # (replay span, call) not yet read
        self._pending = collections.deque()
        if held:
            self.graphs.release()

    # ---------------------------------------------------------------- capture

    def _split(self, args):
        """(leaves of the non-donated arguments, the donated one or None)."""
        rest = tuple(None if i in self.donated else a
                     for i, a in enumerate(args))
        state = args[self.donated[0]] if self.donated else None
        return rest, state

    def _capture(self, args):
        from vkr_tpu_torch import kernels
        from vkr_tpu_torch.raster import setup

        with span("capture", startup=True) as capture:
            rest, state = self._split(args)
            for leaf in _flat(args):
                if (isinstance(leaf, torch.Tensor)
                        and leaf.device.type != self.graphs.device_type):
                    raise ValueError(f"cached_jit: {self.name}: an argument "
                                     f"tensor on {leaf.device}; the captured "
                                     f"frame takes CUDA tensors")

            def buffer(leaf):
                if (isinstance(leaf, torch.Tensor)
                        and leaf.numel() * leaf.element_size() <= INPUT_BYTES):
                    return leaf.clone()
                return leaf
            self._inputs = _map(rest, buffer)
            self._input_leaves = _flat(self._inputs)
            self._arg_leaves = _flat(rest)
            if state is not None:
                for leaf in _flat(state):
                    if not isinstance(leaf, torch.Tensor):
                        raise TypeError(
                            f"cached_jit: {self.name}: the donated argument "
                            f"holds a {type(leaf).__name__}; the captured "
                            f"frame takes tensors")
                self._sets = [_map(state, torch.clone),
                              _map(state, torch.clone)]

            counted, warm = setup.PairPlan(), _WarmUp(self.name)

            def run():
                with setup.pair_plan(counted), _recording(warm):
                    return self.fn(*args)
            self.graphs.warm_up(run)
            self.capacities = setup.static_capacities(counted.counts)
            self._step_specs = warm.specs
            self.collective = warm.collective

            before = dict(kernels.LAUNCHES)
            first = self.record(0)
            # a replay launches what its capture recorded, and counts nothing
            self.launches = {k: n - before.get(k, 0)
                             for k, n in kernels.LAUNCHES.items()
                             if n > before.get(k, 0)}
            recorded = (first, self.record(1))
            self._slots = [(graph, out, _find_overflow(out))
                           for graph, out, _ in recorded]
            self._marks = [marks for _, _, marks in recorded]
            self.host_steps = len(warm.specs)
            self.segments = self.host_steps + 1
            self._ring = self.graphs.pinned(OVERFLOW_RING)
            self._last = 1
            self.captures += 1
        self.capture_seconds = capture.seconds
        if self.verbose:
            print(f"aot: {self.name}: warm-up and two captures in "
                  f"{self.capture_seconds:.2f} s, {self.segments} segments "
                  f"and {self.host_steps} host steps a graph, bin-pair "
                  f"capacities {self.capacities} for counts "
                  f"{counted.counts}", file=sys.stderr, flush=True)

    def record(self, g: int, graphs=None):
        """(graph, out, marks): _body(g) captured by graphs (default the
        frame's), split at its host steps into the warm-up's number of
        segments, and its timing events (PassMarks) if the trace is on,
        else None. The capture's own step; chip_smoke.py's graph_nodes
        records once more with _CudaGraphs(keep_graph=True)."""
        graphs = graphs or self.graphs
        marks = PassMarks(graphs.timing_event) if tracing() else None
        rec = _Capture(self, graphs, self._step_specs)

        def body():
            return self._body(g) if marks is None else marks.whole(
                lambda: self._body(g))
        with _recording(rec), marking(marks):
            graph, out = graphs.capture(body)
        if len(rec.steps) != len(self._step_specs):
            raise RuntimeError(f"cached_jit: {self.name}: the capture made "
                               f"{len(rec.steps)} host steps, its warm-up "
                               f"{len(self._step_specs)}")
        return graph, out, marks

    def _body(self, g: int):
        """What graph g records: fn on the buffers, the binning at the static
        capacities, the new state copied into set 1 - g."""
        from vkr_tpu_torch.raster import setup

        args = list(self._inputs)
        if self.donated:
            args[self.donated[0]] = self._sets[g]
        with setup.pair_plan(setup.PairPlan(self.capacities)):
            out = self.fn(*args)
        if not self.donated:
            return out
        kind = type(self._sets[g])
        at = [i for i, o in enumerate(out) if type(o) is kind] if isinstance(
            out, tuple) else []
        if not at:
            raise TypeError(f"cached_jit: {self.name}: the donated "
                            f"{kind.__name__} must come back among fn's "
                            f"results")
        for dst, src in zip(_flat(self._sets[1 - g]), _flat(out[at[0]])):
            dst.copy_(src)
        return (*out[:at[0]], self._sets[1 - g], *out[at[0] + 1:])

    # ---------------------------------------------------------------- replay

    def _load(self, args, g: int):
        """Copy the call's small tensors and, unless it is the state the
        last call returned, its donated state into graph g's buffers."""
        rest, state = self._split(args)
        leaves = _flat(rest)
        if len(leaves) != len(self._arg_leaves):
            raise ValueError(f"cached_jit: {self.name}: the arguments' "
                             f"structure differs from the captured call's")
        for i, (new, was, buf) in enumerate(zip(leaves, self._arg_leaves,
                                                self._input_leaves)):
            if buf is not was:  # a buffer of the graphs'
                buf.copy_(new)
            elif new is not was and not (
                    not isinstance(new, torch.Tensor) and new == was):
                raise ValueError(
                    f"cached_jit: {self.name}: argument leaf {i} is not the "
                    f"captured call's ({type(was).__name__}): a tensor of "
                    f"more than {INPUT_BYTES} bytes, or a value that is "
                    f"not a tensor, is part of the capture; make a new "
                    f"cached_jit for new ones")
        if state is not None and state is not self._returned:
            for dst, src in zip(_flat(self._sets[g]), _flat(state)):
                dst.copy_(src)

    def _check_overflow(self, block: bool = False):
        """Raise on the first completed replay that dropped bin pairs; with
        block, wait for the oldest pending replay first; a collective
        frame waits for every pending replay."""
        from vkr_tpu_torch.raster import setup

        if self.collective and self._pending:
            with span("wait"):
                self._pending[-1][2].synchronize()
        elif block:
            with span("wait"):
                self._pending[0][2].synchronize()
        while self._pending and self._pending[0][2].query():
            call, slot, _ = self._pending.popleft()
            dropped = int(self._ring[slot])
            if dropped:
                raise BinOverflow(
                    f"cached_jit: {self.name}: call {call} dropped {dropped}"
                    f" bin pairs (overflow) at capacities {self.capacities}"
                    f" (the capture frame's pair counts times "
                    f"{setup.PAIR_HEADROOM}); make a new cached_jit on a "
                    f"view of that frame", call, dropped)

    def __call__(self, *args):
        with span("call", call=new_call() if tracing() else None):
            return self._call(args)

    def _call(self, args):
        if self._slots is None:
            self._capture(args)
        with span("overflow_check"):
            self._check_overflow()
            if len(self._pending) == OVERFLOW_RING:
                self._check_overflow(block=True)
        g = 1 - self._last
        with span("load"):
            self._load(args, g)
        marks, unread = self._marks[g], self._unread[g]
        if unread is not None and tracing():
            with span("read_passes"):
                marks.read(*unread)
        graph, out, overflow = self._slots[g]
        self.step_seconds = 0.0
        with span("replay") as replay:
            graph.replay()
        self._unread[g] = ((replay.id, replay.call)
                           if marks is not None and tracing() else None)
        self.calls += 1
        if overflow is not None:
            slot = self.calls % OVERFLOW_RING
            self._ring[slot:slot + 1].copy_(overflow.reshape(1),
                                            non_blocking=True)
            self._pending.append((self.calls, slot, self.graphs.event()))
        self._last = g
        if self.donated:
            self._returned = self._sets[1 - g]
        return out

