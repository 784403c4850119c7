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
import dataclasses
import os
import sys
import time
from typing import Callable

import torch

from vkr_tpu_torch.core import registry
from vkr_tpu_torch.core.graph import _leaves

# A non-donated tensor argument of at most this many bytes (a camera
# matrix, a jitter, a transform table) is copied into a buffer of the
# graph's own before each replay; a larger one (a scene's vertices and
# textures, a LUT, a probe grid) is read in place.
INPUT_BYTES = 1 << 16
# Overflow readings kept in pinned memory for replays not yet checked.
OVERFLOW_RING = 8


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


class _CudaGraphs:
    """What CapturedFrame asks of CUDA: a warm-up on a side stream, the
    capture of a graph (its own memory pool), events, pinned memory."""

    device_type = "cuda"

    @staticmethod
    def warm_up(run):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = run()
        torch.cuda.current_stream().wait_stream(side)
        return out

    @staticmethod
    def capture(run):
        """(graph, run's result recorded into it); replay() reruns it."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        return graph, out

    @staticmethod
    def event():
        """An event recorded on the current stream."""
        done = torch.cuda.Event()
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

    Overflow is never silent: after each replay the frame's overflow
    (the dropped bin pairs under a dict key or field "overflow") is copied
    without waiting into pinned memory, and each later call reads the
    readings whose replay has completed and raises BinOverflow on one that
    is not 0, naming the call and the count (call_or_recapture goes on
    from it). The caller reads the last frame's aux["overflow"] itself, as
    with the eager frame.

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
        self.calls = 0
        self.captures = 0
        self.cache_clear()

    def cache_clear(self):
        """Drop the graphs, their pools and buffers; the pools go back to
        the device (graphs.release())."""
        held = getattr(self, "_slots", None) is not None
        self._slots = self._sets = self._inputs = self._ring = None
        self._returned = None
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

        t0 = time.perf_counter()
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
                    raise TypeError(f"cached_jit: {self.name}: the donated "
                                    f"argument holds a {type(leaf).__name__}"
                                    f"; the captured frame takes tensors")
            self._sets = [_map(state, torch.clone),
                          _map(state, torch.clone)]

        counted = setup.PairPlan()

        def warm():
            with setup.pair_plan(counted):
                return self.fn(*args)
        self.graphs.warm_up(warm)
        self.capacities = setup.static_capacities(counted.counts)

        before = dict(kernels.LAUNCHES)
        first = self.graphs.capture(lambda: self._body(0))
        # a replay launches what its capture recorded, and counts nothing
        self.launches = {k: n - before.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()
                         if n > before.get(k, 0)}
        self._slots = [(graph, out, _find_overflow(out)) for graph, out in (
            first, self.graphs.capture(lambda: self._body(1)))]
        self._ring = self.graphs.pinned(OVERFLOW_RING)
        self._last = 1
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0
        if self.verbose:
            print(f"aot: {self.name}: warm-up and two captures in "
                  f"{self.capture_seconds:.2f} s, bin-pair capacities "
                  f"{self.capacities} for counts {counted.counts}",
                  file=sys.stderr, flush=True)

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
        block, wait for the oldest pending replay first."""
        from vkr_tpu_torch.raster import setup

        if block:
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
        if self._slots is None:
            self._capture(args)
        self._check_overflow()
        if len(self._pending) == OVERFLOW_RING:
            self._check_overflow(block=True)
        g = 1 - self._last
        self._load(args, g)
        graph, out, overflow = self._slots[g]
        graph.replay()
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

