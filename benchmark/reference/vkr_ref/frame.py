"""The frame function — the reference's main loop as a chain of passes.

Mirrors main.cpp:338-402 frame order and vkr_tpu/frame.py: G-buffer raster
-> hi-Z downsample -> SSR (trace/filter/blur) -> GTAO (main/filter/
accumulate) -> deferred shading -> TAA resolve. The reference's end-of-frame
image remaps (main.cpp:416-420) become the returned FrameState.

Kept for the benchmark: the default RenderConfig (SSR on, MIS GTAO), the
frame with SSR off, probe GI (enable_probes with a grid from
build_probe_grid, BASELINE config 5), ray-traced GTAO (gtao.use_ray_query
with a grid from build_scene_tri_grid) and trilinear material textures
(trilinear_textures), on procedural scenes and on glTF scenes from
scene.load_scene, uniform or at native texture sizes.

Every pass is built through the registry (core/registry.get, the
reference's shader manifest) under add_task with the reference's task
names (core/graph.py), in vkr_tpu's order: a PassGraph records the chain,
and a function swapped on its module reaches the frame.

shade_frame's band=/gather_fn= run the image-space chain in band mode, the
multi-device frame's (parallel/band.py): each expensive pass computes one
band of rows and gather_fn makes its output whole again, as in vkr_tpu.

use_kernels=False is vkr_tpu's use_pallas=False frame, the oracle the
tools compare against: the brute-force G-buffer (render_gbuffer(
oracle=True)), vkr_tpu's exact single-strategy GTAO pass, and each other
kernel's plain version, on any device. tuning= overrides the viewer's
slider scalars (Tuning) for one frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vkr_ref.config import RenderConfig
from vkr_ref.core import registry
from vkr_ref.core.diskcache import cached_npz
from vkr_ref.core.framestate import FrameState
from vkr_ref.core.graph import add_task
from vkr_ref.mathlib.brdf import halton23_table
from vkr_ref.mathlib.transforms import perspective, taa_jitter_sequence
from vkr_ref.passes import gtao as _gtao
from vkr_ref.passes import probes as _probes
from vkr_ref.passes import shading as _shading
from vkr_ref.passes import ssr as _ssr
from vkr_ref.passes import taa as _taa
from vkr_ref.passes.gbuffer import SceneDevice, upload_scene
from vkr_ref.scene.accel import TriGrid, build_tri_grid

# Reference numerics: float32 products in full precision (vkr_tpu runs its
# corner transform at precision="highest"); no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class SSRResources(NamedTuple):
    """Startup-preintegrated LUTs (advanced_ssr.cpp:95-136) + halton table."""

    pdf_lut: torch.Tensor    # (S, S)
    brdf_lut: torch.Tensor   # (S, S, 2)
    halton: torch.Tensor     # (128, 2)


def build_ssr_resources(lut_size: int = 1024,
                        device=_ssr.CUDA) -> SSRResources:
    """The preintegrated LUTs on `device`, the card unless the caller asks
    for another, disk-cached as vkr_tpu caches them (frame.py:42-63; each
    is a pure function of its size). The key names the port and the
    device type: vkr_tpu's `ssr-luts-{size}` entries share the directory
    and come from other code. A warm start returns the arrays a cold start
    built on that device type. "fma" marks the PDF LUT whose contracted
    steps are rounded once (passes/ssr.py:preintegrate_pdf): entries
    written before that hold texels that overflowed to +inf."""
    device = torch.device(device)

    def build():
        return {name: registry.get(prog)(lut_size, device=device)
                .cpu().numpy()
                for name, prog in (("pdf", "pdf_preintegrate"),
                                   ("brdf", "brdf_preintegrate"))}

    luts = cached_npz(
        f"ssr-luts-{lut_size}-vkr_ref-fma-{device.type}", build)
    return SSRResources(
        pdf_lut=torch.from_numpy(luts["pdf"]).to(device),
        brdf_lut=torch.from_numpy(luts["brdf"]).to(device),
        halton=torch.as_tensor(halton23_table(_ssr.HALTON_SEQ_SIZE),
                               device=device))


class Tuning(NamedTuple):
    """Per-frame tuning scalars, 0-d tensors or Python scalars: the
    reference's ImGui-slider push constants (GTAO weight_ratio
    gtao.cpp:533, SSSR max roughness advanced_ssr.cpp:558, the shading
    roughness remap defered_shading.cpp:122-123, SSSR temporal rays), as
    vkr_tpu's frame.Tuning. Unlike RenderConfig they change per frame
    without a new frame function. `Tuning.of(cfg)` takes the config's
    values, which is what the frame uses when no override is passed."""

    weight_ratio: float         # GTAO MIS strategy weight (1..5)
    ssr_max_roughness: float    # SSSR roughness cutoff/bias (0..1)
    shade_min_roughness: float  # shading roughness remap lo (0..1)
    shade_max_roughness: float  # shading roughness remap hi (0..1)
    ssr_temporal_rays: int      # halton counter period (1..128)

    @staticmethod
    def of(cfg: RenderConfig) -> "Tuning":
        return Tuning(
            weight_ratio=cfg.gtao.weight_ratio,
            ssr_max_roughness=cfg.ssr.max_roughness,
            shade_min_roughness=cfg.shading.min_roughness,
            shade_max_roughness=cfg.shading.max_roughness,
            ssr_temporal_rays=cfg.ssr.max_accumulated_rays,
        )


def _tuning(cfg: RenderConfig, tuning) -> Tuning:
    """The slider scalars as the passes read them: Tuning.of(cfg) when
    tuning is None, each float as a float32 0-d tensor. The reference's
    push constants are float32, and so are the viewer's 0-d device tensors
    (tools/viewer.py); a Python float becomes a 0-d CPU tensor, which costs
    no copy to the card, so that a step on the scalars alone (MIS's
    1 / (weight_ratio + 1), shading's max - min) rounds in float32 in
    either form and both give the same frame."""
    t = Tuning.of(cfg) if tuning is None else tuning
    return t._replace(**{
        k: torch.scalar_tensor(float(v), dtype=torch.float32)
        for k, v in t._asdict().items()
        if k != "ssr_temporal_rays" and not isinstance(v, torch.Tensor)})


class CameraFrame(NamedTuple):
    """Per-frame camera matrices (DrawTAAParams analog,
    scene_renderer.hpp:26-33), float32 tensors."""

    view: torch.Tensor        # (4,4)
    prev_view: torch.Tensor
    mvp: torch.Tensor         # proj @ view, unjittered
    prev_mvp: torch.Tensor
    jitter: torch.Tensor      # (2,) NDC offset


def camera_frame(cfg: RenderConfig, view, prev_view, frame_index: int,
                 device, use_jitter: bool = True) -> CameraFrame:
    """The frame's matrices on `device`. The TAA jitter is on where both
    use_jitter (the viewer's `j` key, main.cpp:358) and cfg.taa.jitter
    are. On the card the five arrays go up in one copy from pinned host
    memory, which does not wait for the stream; the values are those of a
    plain copy."""
    proj = perspective(cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                       cfg.camera.zfar)
    seq = taa_jitter_sequence(cfg.width, cfg.height)
    jitter = seq[frame_index % 4] if (use_jitter and cfg.taa.jitter) else (
        np.zeros(2, np.float32))
    parts = [np.asarray(a, np.float32).reshape(-1)
             for a in (view, prev_view, proj @ view, proj @ prev_view,
                       jitter)]
    host = torch.from_numpy(np.concatenate(parts))
    device = torch.device(device)
    if device.type == "cuda":
        flat = host.pin_memory().to(device, non_blocking=True)
    else:
        flat = host.to(device)
    mats = flat[:64].reshape(4, 4, 4)
    return CameraFrame(view=mats[0], prev_view=mats[1], mvp=mats[2],
                       prev_mvp=mats[3], jitter=flat[64:66])


def build_probe_grid(scene_cpu, cfg: RenderConfig, margin: float = 0.5,
                     probe_y: float = 1.5, use_kernels: bool = True,
                     device=_ssr.CUDA) -> _probes.ProbeGrid:
    """Render the octahedral probe grid over the scene's xz bounds on
    `device`, the card unless the caller asks for another (start-up task,
    like the reference's render_probe_grid call site,
    probe_renderer.cpp:290-384). scene_cpu: CompiledScene (host arrays for
    the bounds); the device scene is uploaded here. use_kernels=False
    renders the faces through the brute-force G-buffer."""
    pos = np.asarray(scene_cpu.positions)
    lo = pos.min(axis=0) if len(pos) else np.zeros(3)
    hi = pos.max(axis=0) if len(pos) else np.zeros(3)
    pmin = np.array([lo[0] + margin, probe_y, lo[2] + margin], np.float32)
    pmax = np.array([hi[0] - margin, probe_y, hi[2] - margin], np.float32)
    return _probes.render_probe_grid(
        upload_scene(scene_cpu, device), pmin, pmax, cfg.probes.grid,
        cube_size=cfg.probes.cube_size, oct_size=cfg.probes.oct_size,
        oracle=not use_kernels)


def build_scene_tri_grid(scene_cpu, resolution: int = 48, cap: int = 24,
                         device=_ssr.CUDA) -> TriGrid:
    """The uniform-grid acceleration structure over the scene's world-space
    triangles (the scene_as.cpp BLAS/TLAS build analog; a start-up task on
    the host), on `device`, the card unless the caller asks for another.
    It feeds gtao_rt through render_frame's tri_grid when
    cfg.gtao.use_ray_query is set. scene_cpu: CompiledScene."""
    pos = np.asarray(scene_cpu.positions)
    m = np.asarray(scene_cpu.transforms)[np.asarray(scene_cpu.vert_transform)]
    world = np.einsum("vij,vj->vi", m[:, :3, :3], pos) + m[:, :3, 3]
    return build_tri_grid(world, np.asarray(scene_cpu.tri_indices),
                          resolution=resolution, cap=cap, device=device)


@registry.track_cache
@functools.lru_cache(maxsize=None)
def _rt_direction_table(count: int, device) -> torch.Tensor:
    """ao_ray_directions(count) on `device`, made once: at a captured
    frame's warm-up, before its capture (a pageable copy cannot be
    recorded). Not bounded, as core/constants.py's cache: an evicted table
    would be freed under a graph still reading it."""
    return torch.as_tensor(_gtao.ao_ray_directions(count), device=device)


def compose_probe_reflections(ssr_blurred, rays, probe_rgb):
    """Fill SSR-empty pixels with probe-GI reflections.

    "Empty" is decided by the trace's validity channel (rays w = source
    depth, 1.0 = no hit), not by the blurred colour being black: a
    legitimately black valid reflection survives. The reference never
    composes both (probes are not in its main loop, trace_probe/
    shader.comp:73-84); this fill is vkr_tpu's extension for
    cfg.enable_probes + enable_ssr (PARITY.md)."""
    return torch.where(rays[..., 3:4] >= 1.0, probe_rgb, ssr_blurred)


def render_frame(scene: SceneDevice, state: FrameState, cam: CameraFrame,
                 ssr_res: SSRResources, cfg: RenderConfig, *,
                 probe_grid=None, tri_grid=None, use_kernels: bool = True,
                 tuning: Tuning = None):
    """One frame: returns (final color (H, W, 3), new FrameState, aux).

    probe_grid: the start-up ProbeGrid (build_probe_grid); with
    cfg.enable_probes it feeds indirect reflections into shading. Without
    one the frame is the probeless frame, as in vkr_tpu. tri_grid: the
    start-up TriGrid (build_scene_tri_grid); with cfg.gtao.use_ray_query
    GTAO's main pass is gtao_rt over it. Without one the main pass is the
    one the frame takes with use_ray_query off, as in vkr_tpu.
    use_kernels=False: the oracle frame (module docstring). tuning: the
    slider scalars, Tuning.of(cfg) when None."""
    gbuf = add_task(
        "GbufferPass",
        lambda: registry.get("gbuf_opaque_taa")(
            scene, cam.mvp, cam.prev_mvp, cam.jitter,
            width=cfg.width, height=cfg.height,
            quantize=cfg.quantize_formats,
            mask_peel_layers=cfg.raster.mask_peel_layers,
            trilinear=cfg.trilinear_textures,
            oracle=not use_kernels,
        ),
    )
    return shade_frame(gbuf, state, cam, ssr_res, cfg, probe_grid=probe_grid,
                       tri_grid=tri_grid, use_kernels=use_kernels,
                       tuning=tuning)


def shade_frame(gbuf, state: FrameState, cam: CameraFrame,
                ssr_res: SSRResources, cfg: RenderConfig, *, probe_grid=None,
                tri_grid=None, use_kernels: bool = True,
                tuning: Tuning = None, band=None, gather_fn=None):
    """The image-space chain after the G-buffer (hi-Z -> SSR -> GTAO ->
    shading -> TAA -> history) = frame_mid, then frame_tail, as vkr_tpu's
    shade_frame. Returns (final color, new FrameState, aux).

    band=(row0, band_h), gather_fn (the multi-device frame,
    parallel/band.py; vkr_tpu frame.py:228): every expensive pass computes
    the full-res rows [row0, row0 + band_h) (half-res [row0/2, ...)) from
    whole-frame inputs, and gather_fn, which takes bands (band rows, ...)
    to the whole (H rows, ...), makes each output whole for the next pass
    (one band -> a tensor, several -> a tuple; outputs that follow each
    other go in one call, one host step of a captured gloo frame). hi-Z
    and the histories stay whole on every caller. row0 and band_h must be
    even. The result is whole. band=None is the one-device frame."""
    mid = frame_mid(gbuf, state, cam, ssr_res, cfg, probe_grid=probe_grid,
                    tri_grid=tri_grid, use_kernels=use_kernels,
                    tuning=tuning, band=band, gather_fn=gather_fn)
    return frame_tail(gbuf, mid, state, cam, ssr_res, cfg,
                      use_kernels=use_kernels, tuning=tuning, band=band,
                      gather_fn=gather_fn)


def _banding(band, gather_fn):
    """(row0, band_h, gather) of band mode; (None, None, identity) off."""
    if band is None:
        return None, None, lambda *xs: xs[0] if len(xs) == 1 else xs
    if gather_fn is None:
        raise ValueError("band mode needs a gather_fn")
    row0, band_h = band
    if row0 % 2 or band_h % 2:
        raise ValueError(f"band {band}: row0 and band_h must be even")
    return row0, band_h, gather_fn


def frame_mid(gbuf, state: FrameState, cam: CameraFrame,
              ssr_res: SSRResources, cfg: RenderConfig, *, probe_grid=None,
              tri_grid=None, use_kernels: bool = True,
              tuning: Tuning = None, band=None, gather_fn=None):
    """hi-Z downsample -> SSR (trace/filter/blur) -> probe GI -> GTAO
    (main/filter/accumulate). Returns the dict of products the tail
    consumes. band/gather_fn: shade_frame's (vkr_tpu frame.py:242)."""
    h, w = cfg.height, cfg.width
    t = _tuning(cfg, tuning)
    dev = gbuf.depth.device
    row0, band_h, g = _banding(band, gather_fn)
    # band mode's half-res rows; the one-device frame calls every pass as
    # it did before band mode
    hb = {} if band is None else dict(row0=row0 // 2, band_h=band_h // 2)
    inv_view = _inv4(cam.view)
    prev_inv_view = _inv4(cam.prev_view)
    nm = _normal_mat4(cam.view)
    hiz = add_task(
        "DownsampleGbuffer",
        lambda: registry.get("downsample_hiz")(gbuf.depth, gbuf.normal,
                                               gbuf.velocity))
    depth_half = hiz.mips[0]

    # ---- SSR (ssr.run: trace -> filter -> blur) ----
    if cfg.enable_ssr:
        sp = _ssr.SSRParams(
            normal_mat=nm, fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
            max_roughness=t.ssr_max_roughness,
        )
        # the reference's per-frame halton counter: ++ modulo
        # max_accumulated_rays when update_random, else frozen
        # (advanced_ssr.cpp:168-170 / 237-239); a device int32, as in
        # vkr_tpu (frame.py:284-288)
        frame_random = (state.frame_index % t.ssr_temporal_rays
                        if cfg.ssr.update_random
                        else torch.zeros_like(state.frame_index))
        pyr = _ssr.pack_pyramid(hiz.mips)
        rays, ssr_occ = add_task(
            "SSSR_trace",
            lambda: registry.get("sssr_trace")(
                pyr, hiz.normal_half, gbuf.material, ssr_res.pdf_lut, sp,
                frame_random, ssr_res.halton,
                max_iterations=cfg.ssr.max_iterations,
                use_kernel=use_kernels, **hb))
        rays_band = rays
        rays, ssr_occ = g(rays, ssr_occ)
        reflections = g(add_task(
            "SSSR_filter",
            lambda: registry.get("sssr_filter")(
                rays, depth_half, gbuf.albedo, hiz.normal_half,
                gbuf.material, sp,
                flags_normalize=cfg.ssr.normalize_filter,
                flags_bilateral=cfg.ssr.bilateral_filter, **hb)))
        blur_params = _ssr.SSRBlurParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
            max_roughness=t.ssr_max_roughness,
            accumulate=cfg.ssr.accumulate,
            disable_blur=not cfg.ssr.use_blur,
        )
        ssr_blurred = add_task(
            "SSSR_blur",
            lambda: registry.get("sssr_blur")(
                reflections, depth_half, hiz.normal_half, gbuf.material,
                state.ssr_history, hiz.velocity_half, state.prev_depth_half,
                blur_params, use_kernel_gather=use_kernels, **hb))
    else:
        ssr_occ = None
        # SSR off: shading sees no reflections
        ssr_blurred = torch.zeros((hb.get("band_h", h // 2), w // 2, 3),
                                  dtype=torch.float32, device=dev)

    # ---- Probe GI -> indirect reflections (BASELINE config 5) ----
    # The reference's ProbeTracePass writes the reflections image deferred
    # shading reads (trace_probe/shader.comp:73-84 -> defered_shading/
    # shader.frag:92). With SSR also on, probe hits fill the pixels SSR
    # left empty.
    probe_refl = None
    if cfg.enable_probes and probe_grid is not None:
        probe_refl = add_task(
            "TraceProbes",
            lambda: registry.get("trace_probe")(
                depth_half, hiz.normal_half, probe_grid, inv_view,
                cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                cfg.camera.zfar, **hb))
        probe_rgb = probe_refl[..., :3] * probe_refl[..., 3:4]
        ssr_blurred = (compose_probe_reflections(ssr_blurred, rays_band,
                                                 probe_rgb)
                       if cfg.enable_ssr else probe_rgb)
        probe_refl, ssr_blurred = g(probe_refl, ssr_blurred)
    else:
        ssr_blurred = g(ssr_blurred)

    if cfg.enable_gtao:
        gp = _gtao.GTAOParams(
            normal_mat=nm, fovy=cfg.camera.fovy,
            aspect=cfg.aspect, znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        base_angle = _gtao.frame_base_angle(state.frame_index)
        if cfg.gtao.use_ray_query and tri_grid is not None:
            # ray-query GTAO against the scene grid (gtao.cpp:150-196,
            # rt_main.frag); filter and accumulate run unchanged after it
            rt_dirs = _rt_direction_table(cfg.gtao.rt_directions, dev)
            raw_ao = add_task(
                "GTAO_rt",
                lambda: registry.get("gtao_rt")(
                    depth_half, hiz.normal_half, tri_grid, inv_view,
                    cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                    cfg.camera.zfar, base_angle, rt_dirs,
                    rt_radius=cfg.gtao.rt_radius, **hb))
        elif cfg.gtao.mis and ssr_occ is not None:
            # the reference's default main pass (gtao.hpp:112 mis_gtao):
            # MIS with the SSR trace's GGX occlusion estimate
            raw_ao = add_task(
                "GTAO_main",
                lambda: registry.get("gtao_main_mis")(
                    depth_half, hiz.normal_half, gbuf.material,
                    ssr_res.pdf_lut, ssr_occ, gp, base_angle,
                    weight_ratio=t.weight_ratio,
                    reflections_only=cfg.gtao.reflections_only,
                    use_kernel=use_kernels, **hb))
        else:
            # without SSR's occlusion estimate the MIS main pass cannot
            # run; like vkr_tpu, the frame takes the single-strategy pass:
            # K4's, or in the oracle frame vkr_tpu's exact one
            raw_ao = add_task(
                "GTAO_main",
                lambda: registry.get(
                    "gtao_main" if use_kernels else "gtao_compute_main")(
                    depth_half, hiz.normal_half, gp, base_angle,
                    2 if cfg.gtao.two_directions else 1, **hb))
        raw_ao = g(raw_ao)
        filtered_ao = g(add_task(
            "GTAO_filter",
            lambda: registry.get("gtao_filter")(
                depth_half, raw_ao, cfg.camera.znear, cfg.camera.zfar,
                **hb)))
        ap = _gtao.GTAOAccumParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            mvp=cam.mvp, fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        gtao_accum = g(add_task(
            "GTAO_accumulate",
            lambda: registry.get("gtao_accumulate")(
                depth_half, state.prev_depth_half, filtered_ao,
                hiz.velocity_half, state.gtao_accum, ap,
                clear_history=state.frame_index == 0,
                use_kernel_gather=use_kernels, **hb)))
        occlusion = gtao_accum[..., 0]
    else:
        gtao_accum = state.gtao_accum
        occlusion = torch.ones((h // 2, w // 2), dtype=torch.float32,
                               device=dev)
    return {"depth_half": depth_half, "ssr_blurred": ssr_blurred,
            "gtao_accum": gtao_accum, "occlusion": occlusion,
            "probe": probe_refl, "ssr_rays": rays if cfg.enable_ssr else None}


def frame_tail(gbuf, mid, state: FrameState, cam: CameraFrame,
               ssr_res: SSRResources, cfg: RenderConfig, *,
               use_kernels: bool = True, tuning: Tuning = None, band=None,
               gather_fn=None):
    """Deferred shading -> TAA -> end-of-frame history remaps
    (main.cpp:416-420). Returns (final color, new FrameState, aux).
    band/gather_fn: shade_frame's (vkr_tpu frame.py:389)."""
    t = _tuning(cfg, tuning)
    row0, band_h, g = _banding(band, gather_fn)
    fb = {} if band is None else dict(row0=row0, band_h=band_h)
    inv_view = _inv4(cam.view)
    prev_inv_view = _inv4(cam.prev_view)
    depth_half = mid["depth_half"]
    occlusion = mid["occlusion"]

    shade_params = _shading.ShadingParams(
        inverse_camera=inv_view, fovy=cfg.camera.fovy, aspect=cfg.aspect,
        znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        min_roughness=t.shade_min_roughness,
        max_roughness=t.shade_max_roughness,
        show_ao=cfg.show_ao_only,
    )
    color = g(add_task(
        "DeferedShading",
        lambda: registry.get("defered_shading")(
            gbuf, shade_params, occlusion=occlusion,
            reflections=mid["ssr_blurred"], brdf_lut=ssr_res.brdf_lut,
            depth_half=depth_half, **fb)))

    if cfg.enable_taa:
        tp = _taa.TAAParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        final = g(add_task(
            "TAA",
            lambda: registry.get("taa_resolve")(
                state.taa_history, state.prev_depth, gbuf.depth,
                gbuf.velocity, color, tp, use_kernel_gather=use_kernels,
                **fb)))
    else:
        final = color

    # ---- history remaps (main.cpp:416-420) ----
    new_state = state.replace(
        prev_depth=gbuf.depth,
        prev_depth_half=depth_half,
        taa_history=final,
        gtao_accum=mid["gtao_accum"],
        gtao_prev=occlusion,
        ssr_history=mid["ssr_blurred"],
        prev_mvp=cam.mvp,
        frame_index=state.frame_index + 1,
    )
    aux = {"gbuffer": gbuf, "hiz_depth": depth_half,
           "ssr": mid["ssr_blurred"], "ao": occlusion,
           "overflow": gbuf.overflow,
           # the probe trace (H/2, W/2, 4) and the SSR trace's rays (w = 1:
           # no hit), or None where the pass did not run
           "probe": mid["probe"], "ssr_rays": mid["ssr_rays"]}
    return final, new_state, aux


def _inv4(view):
    """Inverse of a rigid view matrix."""
    r = view[:3, :3]
    t = view[:3, 3]
    out = torch.eye(4, dtype=view.dtype, device=view.device)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def _normal_mat4(view):
    """transpose(inverse(view)) for a rigid view = rotation part unchanged,
    as a 4x4 (main.cpp:377)."""
    return _inv4(view).T
