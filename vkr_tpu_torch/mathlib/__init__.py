from vkr_tpu_torch.mathlib.transforms import (
    look_at,
    perspective,
    normal_matrix,
    taa_jitter_sequence,
)
from vkr_tpu_torch.mathlib.octahedral import encode_normal, decode_normal
from vkr_tpu_torch.mathlib.projection import (
    linearize_depth,
    reconstruct_view_vec,
    project_view_vec,
)
