"""scene_upload_s: seconds of the scene's upload to the device (textures
packed, corner tables built), the program's start-up span "upload"
(vkr_tpu_torch/passes/gbuffer.py:upload_scene) summed by
vkr_tpu_torch.core.graph.trace_summary. The program records it with its
trace on or off; the trace read is the run's ctx.program_trace where the
harness took one, else the process's. None where the program records no
such span. Moves setup_s."""


def read(ctx):
    try:
        from vkr_tpu_torch.core import graph

        summary, snapshot = graph.trace_summary, graph.trace_snapshot
    except (ImportError, AttributeError):
        return None
    snap = getattr(ctx, "program_trace", None)
    return summary(snapshot() if snap is None else snap)["host_s"].get(
        "upload")
