"""texture_resize_s: seconds of the start-up's texture resizes and mips,
the program's start-up spans "resize" (vkr_tpu_torch/scene/procedural.py:
sponza_texture_set, one an image, and scene/scene.py:compile_scene)
summed by vkr_tpu_torch.core.graph.trace_summary. The program records
them with its trace on or off; the trace read is the run's
ctx.program_trace where the harness took one, else the process's. None
where the program records no such span. Moves setup_s."""


def read(ctx):
    try:
        from vkr_tpu_torch.core import graph

        summary, snapshot = graph.trace_summary, graph.trace_snapshot
    except (ImportError, AttributeError):
        return None
    snap = getattr(ctx, "program_trace", None)
    return summary(snapshot() if snap is None else snap)["host_s"].get(
        "resize")
