"""Pass-DAG orchestration — the rendergraph analog, as vkr_tpu/core/graph.py
has it.

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
    printed for inspection or held in tests;
  * per-pass timing (PassProfiler), with the card synchronised before and
    after each pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    (a record reads shapes and dtypes only)."""
    with torch.profiler.record_function(name), _nvtx(name):
        out = fn(*args, **kwargs)
    graph = PassGraph._active
    if graph is not None:
        graph.records.append(
            PassRecord(name, _describe((args, kwargs)), _describe(out)))
    return out


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PassProfiler:
    """Per-pass wall-clock timing: the card is synchronised before and after
    each pass (vkr_tpu blocks on the pass's inputs and outputs). The analog
    of reading per-task debug labels in a RenderDoc capture."""

    def __init__(self) -> None:
        self.times_ms: Dict[str, float] = {}

    def run(self, name: str, fn: Callable, *args, **kwargs):
        _synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize()
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3
        return out

    def report(self) -> str:
        total = sum(self.times_ms.values())
        lines = [f"{'pass':<24} ms"]
        for name, ms in self.times_ms.items():
            lines.append(f"{name:<24} {ms:7.3f}")
        lines.append(f"{'TOTAL':<24} {total:7.3f}")
        return "\n".join(lines)
