"""nccl_ms_per_frame: device milliseconds in NCCL kernels per frame on the
slowest rank, in the profiled window; the time includes waiting for the
other ranks. None where no rank ran an NCCL kernel. Moves frame_ms."""


def read(ctx):
    per = [r["nccl_s"] / r["frames"] for r in ctx.ranks if r["nccl_s"] > 0]
    return max(per) * 1e3 if per else None
