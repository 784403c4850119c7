"""Multi-device rendering over torch.distributed (vkr_tpu/parallel): the
pixel-band frame (band.py) and view parallelism (sharding.py)."""

from vkr_tpu_torch.parallel.band import render_frame_banded  # noqa: F401
from vkr_tpu_torch.parallel.sharding import (  # noqa: F401
    RenderMesh,
    batch_cams,
    batch_states,
    make_render_mesh,
    render_views_sharded,
)
