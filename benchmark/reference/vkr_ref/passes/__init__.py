"""Render passes — one module per reference pass (src/*.cpp) plus its
shader manifest: importing this package registers every pass entry point
in vkr_ref.core.registry under the reference's src/shaders/
config.json program names, as vkr_tpu/passes/__init__.py does. Only the
passes of the benchmark's frames are kept: SSAO, the simple SSR, shadows,
the tiled SSR trace and their helpers are not."""

from vkr_ref.passes import (  # noqa: F401
    downsample,
    gbuffer,
    gtao,
    probes,
    sampling,
    shading,
    ssr,
    ssr_march,
    taa,
)
