"""The reduction from a profiler trace to numbers: device busy time as the
union of kernel and copy intervals, the idle gaps and what the host was
doing in each, device time by operation name.

Times are in seconds. An interval is (start, end, name); a trace's device
intervals are its kernels, copies and sets, its host intervals the host's
operations and runtime calls.
"""

from __future__ import annotations

import bisect


def merged(intervals, lo, hi):
    """The union of intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def busy_seconds(intervals, lo, hi) -> float:
    """Seconds of [lo, hi] in which some device interval ran."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi], longest first."""
    busy = merged(intervals, lo, hi)
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def host_label(host, t) -> str:
    """The innermost host interval that covers time t ("host idle" when
    none does): what the host was doing then."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return "host idle" if best is None else best[2]


def idle_gaps(intervals, host, lo, hi, top=10):
    """[(what the host was doing, seconds)] of the `top` longest idle gaps
    of [lo, hi], longest first, each named by the host interval at its
    middle."""
    return [(host_label(host, (s + e) / 2), e - s)
            for s, e in gaps(intervals, lo, hi)[:top]]


def by_name(intervals, lo=None, hi=None):
    """{name: device seconds}, intervals that start in [lo, hi] (all when
    unbounded)."""
    out = {}
    for s, e, name in intervals:
        if (lo is None or s >= lo) and (hi is None or s <= hi):
            out[name] = out.get(name, 0.0) + (e - s)
    return out


def top_ops(intervals, lo, hi, top=10):
    """[(name, device seconds)] of the operations that took most time."""
    return sorted(by_name(intervals, lo, hi).items(),
                  key=lambda kv: -kv[1])[:top]


def count_in(intervals, lo, hi) -> int:
    """Device intervals that start in [lo, hi]."""
    starts = sorted(s for s, *_ in intervals)
    return bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo)


def from_profiler(prof, window_name):
    """(device intervals, host intervals, window (lo, hi)) of a finished
    torch.profiler run whose driving thread marked its window with
    record_function(window_name); None when the trace holds no such
    window. Device intervals are the CUDA kernels, copies and sets (not
    the annotations the profiler mirrors onto the device's timeline);
    host intervals the host's operations and runtime calls."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        iv = (s, s + e.duration_ns() * 1e-9, e.name())
        annotation = (e.name() == window_name
                      or e.name().startswith("ProfilerStep")
                      or getattr(e, "is_user_annotation", lambda: False)())
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device.append(iv)
        elif e.name() == window_name:
            window = iv[:2]
        elif not annotation:
            host.append(iv)
    if window is None:
        return None
    return device, host, window
