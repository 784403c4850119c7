"""The raster layer: SoA front end, pair rows, the G-buffer kernel (K1),
texture sampling and the window-gather kernels (K4/K5/K6). The names
below are vkr_tpu/raster/__init__.py's."""

from vkr_ref.raster.setup import (
    transform_vertices,
    transform_normals,
    clip_near_triangles,
    triangle_setup,
    bin_triangles,
    TriangleSetup,
)
from vkr_ref.raster.kernel import (
    rasterize_tiles,
    rasterize_reference,
)
from vkr_ref.raster.resolve import (
    corner_attributes,
    pixel_barycentrics,
    interpolate,
    interpolate_many,
)
from vkr_ref.raster.pipeline import rasterize, VisibilityBuffer
