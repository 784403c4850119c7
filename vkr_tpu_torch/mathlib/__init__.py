from vkr_tpu_torch.mathlib.transforms import (
    look_at,
    perspective_vk,
    perspective,
    inverse_rigid,
    normal_matrix,
    taa_jitter_sequence,
)
from vkr_tpu_torch.mathlib.octahedral import (
    encode_normal,
    decode_normal,
    oct_encode_dir,
    oct_decode_dir,
)
from vkr_tpu_torch.mathlib.projection import (
    linearize_depth,
    encode_depth,
    reconstruct_view_vec,
    project_view_vec,
)
