"""device_idle_share: 1 - (the union of kernel and copy intervals / the
profiled window's wall), in %, on the card that idled most. Moves
frame_ms."""


def read(ctx):
    if not ctx.ranks:
        return None
    return max(100.0 * (1.0 - r["busy_s"] / r["window_s"])
               for r in ctx.ranks)
