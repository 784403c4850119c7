"""gather_roofline: the window gathers' share of their bytes bound, in %.

The bound is the bytes of the frame's K4, K5 and K6 calls (shapes
recorded at the capture; each input byte read once, each output byte
written once: harness/work.py) over the H100's 3.35 TB/s; the time is the
device time of those kernels in the profiled window, per frame. None
where the trace shows no such kernel or no call was recorded. The card's
power limit is printed beside it. Moves frame_ms."""

from harness.peaks import PEAK_BYTES_PER_S


def read(ctx):
    if not ctx.gather_bytes_per_frame or not ctx.ranks:
        return None
    r = ctx.ranks[0]
    if r["gather_s"] <= 0:
        return None
    bound_s = ctx.gather_bytes_per_frame / PEAK_BYTES_PER_S
    return 100.0 * bound_s / (r["gather_s"] / r["frames"])
