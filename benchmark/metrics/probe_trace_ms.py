"""probe_trace_ms: device milliseconds of the probe trace (registry
"trace_probe", TraceProbes) on the frame's half-res depth and normals,
captured alone by cached_jit and replayed back to back between two CUDA
events (see harness/program.py:segment_ms). Moves frame_ms."""


def read(ctx):
    if not ctx.segments_ms:
        return None
    return ctx.segments_ms.get("probe_trace")
