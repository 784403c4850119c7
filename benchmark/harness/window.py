"""The measured window: a closed loop that keeps `in_flight` frames
dispatched, and the statistics users feel, taken from its completion
times.

Frame k is dispatched, then the oldest frame still in flight is waited
for once `in_flight` are: with 2, frame k is queued while frame k-1 runs,
as a game loop keeps them through its swapchain. A frame's completion is
the host time at which an event recorded after it has passed.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Window:
    start: float                 # host clock at the first dispatch
    completions: list            # host clock at each frame's completion
    host_call_s: list            # host seconds of each call into the frame
    failed: int = 0              # frames whose replay dropped bin pairs

    @property
    def frames(self) -> int:
        return len(self.completions)

    @property
    def end(self) -> float:
        return self.completions[-1]


def frame_ms(start: float, completions) -> float:
    """The window's wall time divided by the frames completed in it."""
    return (completions[-1] - start) / len(completions) * 1e3


def intervals_ms(start: float, completions) -> np.ndarray:
    """The window's completion intervals, the first from its start: one a
    frame."""
    return np.diff(np.asarray([start, *completions], np.float64)) * 1e3


def frame_p95_ms(start: float, completions) -> float:
    """The 95th percentile of all completion intervals in the window."""
    return float(np.percentile(intervals_ms(start, completions), 95))


def describe(win: Window) -> str:
    """The completion intervals' quantiles, for the log."""
    iv = intervals_ms(win.start, win.completions)
    q = np.percentile(iv, [5, 25, 50, 75, 95])
    return ("intervals ms p5/p25/p50/p75/p95/max "
            + "/".join(f"{x:.3f}" for x in (*q, iv.max())))


class Events:
    """Completion markers: CUDA events on a card, nothing on the CPU,
    whose frame is done when its call returns."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def record(self):
        if not self.cuda:
            return None
        import torch

        e = torch.cuda.Event()
        e.record()
        return e

    @staticmethod
    def wait(e):
        if e is not None:
            e.synchronize()


def run(dispatch, seconds, in_flight, first_frame, events: Events,
        keep_going=None) -> Window:
    """Dispatch frames first_frame, first_frame + 1, ... (dispatch(k)
    returns True where frame k's replay dropped bin pairs) while
    keep_going(k, elapsed) holds (default: elapsed < seconds), then wait
    for the last. The window closes with the last completion."""
    if keep_going is None:
        def keep_going(k, elapsed):
            return elapsed < seconds
    pending = collections.deque()
    completions, host_s, failed = [], [], 0
    k = first_frame
    start = time.perf_counter()
    while keep_going(k, time.perf_counter() - start):
        t0 = time.perf_counter()
        failed += bool(dispatch(k))
        host_s.append(time.perf_counter() - t0)
        pending.append(events.record())
        if len(pending) >= in_flight:
            events.wait(pending.popleft())
            completions.append(time.perf_counter())
        k += 1
    while pending:
        events.wait(pending.popleft())
        completions.append(time.perf_counter())
    return Window(start=start, completions=completions, host_call_s=host_s,
                  failed=failed)
