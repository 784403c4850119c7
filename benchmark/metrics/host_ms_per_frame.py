"""host_ms_per_frame: host milliseconds of a call into the captured frame,
by the harness's clock around each call of the measured window, averaged
over the window (the slowest rank on several cards). Moves frame_ms."""


def read(ctx):
    means = [sum(c) / len(c) for c in ctx.host_call_s if c]
    return max(means) * 1e3 if means else None
