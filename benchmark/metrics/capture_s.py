"""capture_s: the captured frame's warm-up and two captures in seconds,
as the runtime counts them (CapturedFrame.capture_seconds; the slowest
rank on several cards). Moves setup_s."""


def read(ctx):
    return ctx.capture_s
