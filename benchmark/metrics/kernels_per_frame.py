"""kernels_per_frame: device kernels, copies and sets per frame in the
profiled window, on the card that ran most. Moves frame_ms."""


def read(ctx):
    if not ctx.ranks:
        return None
    return max(r["device_ops"] / r["frames"] for r in ctx.ranks)
