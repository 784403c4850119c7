"""The runtime layer: storage formats, FrameState, and vkr_tpu/core's
registry (shader manifest, hot reload), pass graph (task labels, DAG dump)
and trace (spans and counters), readback and capture, FrameState
checkpoints, the start-up disk cache and the warm-start entry
(aot.cached_jit)."""

from vkr_tpu_torch.core import (  # noqa: F401
    aot,
    checkpoint,
    diskcache,
    graph,
    readback,
    registry,
)
from vkr_tpu_torch.core.formats import (
    quantize_unorm,
    srgb_to_linear,
    linear_to_srgb,
    quantize_f16,
)
from vkr_tpu_torch.core.framestate import FrameState
from vkr_tpu_torch.core.graph import PassGraph, add_task
