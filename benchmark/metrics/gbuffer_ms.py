"""gbuffer_ms: device milliseconds of the frame's gbuffer segment, captured
alone by cached_jit and replayed back to back between two CUDA events
(see harness/program.py:segment_ms). Moves frame_ms."""


def read(ctx):
    if not ctx.segments_ms:
        return None
    return ctx.segments_ms.get("gbuffer")
