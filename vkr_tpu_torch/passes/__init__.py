"""Render passes — one module per reference pass (src/*.cpp) plus its
shader manifest: importing this package registers every pass entry point
in vkr_tpu_torch.core.registry under the reference's src/shaders/
config.json program names, as vkr_tpu/passes/__init__.py does."""

from vkr_tpu_torch.passes import (  # noqa: F401
    downsample,
    gbuffer,
    gtao,
    probes,
    sampling,
    screen_trace,
    shading,
    shadows,
    simple_ssr,
    ssao,
    ssr,
    ssr_march,
    ssr_tiles,
    taa,
    trace_samples,
    util_passes,
)
