"""Typed render configuration (the same dataclasses as vkr_tpu.config, so a
config's JSON round-trips between the two packages).

The reference hard-codes its knobs across main.cpp / pass constructors
(resolution 2560x1440 at main.cpp:217-218, fovy 60deg / znear 0.05 / zfar 80 at
main.cpp:294, GTAO sample count at shaders/gtao/main.comp:53, SSR iteration cap
at shaders/advanced_ssr/trace.comp:91, probe sizes probe_renderer.hpp:6-7).
Here they live in one dataclass (SURVEY.md §5.6 rebuild note).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Projection constants (reference main.cpp:294)."""

    fovy: float = math.radians(60.0)
    znear: float = 0.05
    zfar: float = 80.0


@dataclasses.dataclass(frozen=True)
class GTAOConfig:
    """GTAO knobs (reference gtao.cpp:20-24, shaders/gtao/main.comp:36-53)."""

    samples: int = 20            # march steps per direction side
    radius: float = 1.0          # world-space AO radius (main.comp RADIUS)
    max_thickness: float = 0.1   # MAX_THIKNESS break heuristic
    pattern_n: int = 4           # rotating direction pattern period
    two_directions: bool = False # AO_MODE in main.comp
    # MIS AO+reflection main-pass mode — the reference DEFAULT
    # (gtao.hpp:112 mis_gtao = true; main.comp:60-62 takes the
    # mis_gtao() branch). Requires enable_ssr (the SSR trace's
    # occlusion estimate is the second MIS sampling strategy); the
    # frame falls back to gtao_main when SSR is off.
    mis: bool = True
    weight_ratio: float = 1.0    # MIS strategy weight (gtao.hpp:116)
    reflections_only: bool = False  # debug view (gtao.cpp:532)
    # ray-traced GTAO against the scene acceleration structure
    # (gtao.cpp:150-196 + shaders/gtao/rt_main.frag); off by default
    # exactly like the reference's USE_RAY_QUERY=0 (main.cpp:40)
    use_ray_query: bool = False
    rt_directions: int = 64      # DIRECTION_COUNT (rt_main.frag:19)
    rt_radius: float = 0.2       # scaled_dir length (rt_main.frag:94)


@dataclasses.dataclass(frozen=True)
class SSRConfig:
    """SSSR knobs (reference advanced_ssr.{hpp,cpp}, shaders/advanced_ssr/*)."""

    max_iterations: int = 80     # hi-Z march cap (trace.comp:91)
    max_roughness: float = 1.0   # settings.max_roughness
    glossy_roughness: float = 0.2
    lut_size: int = 1024         # preintegrated PDF / BRDF LUT resolution
    halton_samples: int = 128    # HALTON_SEQ_SIZE (advanced_ssr.cpp:6)
    accumulate: bool = True
    bilateral_filter: bool = True
    normalize_filter: bool = True
    update_probes: bool = True
    # settings.update_random / use_blur / max_accumulated_rays
    # (advanced_ssr.hpp:73-77): the per-frame halton counter advances
    # modulo max_accumulated_rays ("Temporal rays" slider); use_blur off
    # pins the blur gaussian at sigma=0.35 (blur.comp:46-48)
    update_random: bool = True
    use_blur: bool = True
    max_accumulated_rays: int = 16


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """Deferred-shading knobs (defered_shading.hpp:30 min_max_roughness,
    the reference's Shading UI sliders defered_shading.cpp:122-123)."""

    min_roughness: float = 0.0
    max_roughness: float = 1.0


@dataclasses.dataclass(frozen=True)
class TAAConfig:
    """TAA knobs (reference taa/resolve.comp, main.cpp:93-116)."""

    blend: float = 0.1           # history blend weight (resolve.comp:52)
    jitter: bool = True


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Octahedral probe knobs (reference probe_renderer.hpp:6-7)."""

    oct_size: int = 256          # PROBE_SIZE
    cube_size: int = 128         # CUBE_SIZE
    grid: int = 4                # probes per axis in the probe grid


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Pallas rasterizer tiling knobs (no reference analog: replaces Vulkan
    fixed-function raster). Tile shape is (8, 128)-aligned for the VPU."""

    tile_h: int = 8
    tile_w: int = 128
    tri_chunk: int = 16            # triangles processed per inner-loop step
    max_pairs_factor: float = 8.0  # bin-pair capacity = factor * num_triangles
    alpha_mask: bool = True        # honor alpha-discard (opaque_taa.frag:32-34)
    # Depth-peeled alpha-MASK transparency layers. 2 is oracle-exact on
    # the bench workload: vs an arbitrary-depth peel oracle over all 16
    # orbit frames at 1080p, cap=2 mislabels 8 px total (66.2 dB) while
    # cap=1 mislabels 12,693 px (34.2 dB, below the 40 dB golden bar) —
    # experiments/mask_peel_oracle.py. Matches the reference's
    # per-fragment discard (opaque_taa.frag:32-44) to measured exactness.
    mask_peel_layers: int = 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level configuration for a frame pipeline."""

    width: int = 1920
    height: int = 1080
    camera: CameraConfig = CameraConfig()
    gtao: GTAOConfig = GTAOConfig()
    ssr: SSRConfig = SSRConfig()
    shading: ShadingConfig = ShadingConfig()
    taa: TAAConfig = TAAConfig()
    probes: ProbeConfig = ProbeConfig()
    raster: RasterConfig = RasterConfig()
    # Pass toggles (reference ImGui checkboxes; SURVEY.md §5.6)
    enable_gtao: bool = True
    enable_ssr: bool = True
    enable_taa: bool = True
    enable_probes: bool = False
    show_ao_only: bool = False     # defered_shading.cpp:120-126 debug view
    # DEFAULT_SAMPLER's trilinear mip filter for G-buffer texturing
    # (samplers.hpp:36-50); default off — bilinear-at-rounded-mip
    # halves the 32-byte pair gathers (tracked deviation, ROADMAP)
    trilinear_textures: bool = False
    # Emulate the reference's quantized storage formats at pass boundaries
    # (unorm8 albedo, unorm16 oct normals, D24 depth) for PSNR parity.
    quantize_formats: bool = True

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def half_res(self) -> Tuple[int, int]:
        return self.height // 2, self.width // 2

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        raw = json.loads(text)
        sub = {
            "camera": CameraConfig,
            "gtao": GTAOConfig,
            "ssr": SSRConfig,
            "shading": ShadingConfig,
            "taa": TAAConfig,
            "probes": ProbeConfig,
            "raster": RasterConfig,
        }
        kwargs = {}
        for key, value in raw.items():
            if key in sub:
                kwargs[key] = sub[key](**value)
            else:
                kwargs[key] = value
        return RenderConfig(**kwargs)
