from vkr_tpu_torch.core.formats import (
    quantize_unorm,
    srgb_to_linear,
    linear_to_srgb,
    quantize_f16,
)
from vkr_tpu_torch.core.framestate import FrameState
