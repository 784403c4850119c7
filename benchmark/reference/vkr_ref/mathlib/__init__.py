from vkr_ref.mathlib.transforms import (
    look_at,
    perspective_vk,
    perspective,
    inverse_rigid,
    normal_matrix,
    taa_jitter_sequence,
)
from vkr_ref.mathlib.octahedral import (
    encode_normal,
    decode_normal,
    oct_encode_dir,
    oct_decode_dir,
)
from vkr_ref.mathlib.projection import (
    linearize_depth,
    encode_depth,
    reconstruct_view_vec,
    project_view_vec,
)
