"""The system under test: vkr_tpu_torch, driven through its public scene,
frame and runtime functions. The only module of the harness that imports
the program.

A configuration file (benchmark/configs/<config>.json) names:
  render     the RenderConfig, field for field (RenderConfig.from_json)
  scene      kind "colonnade" (procedural.colonnade_scene) or
             "sponza_colonnade" (procedural.sponza_colonnade_scene over
             the Sponza stand-in, written from the seed at standin_scale
             times its image sizes), with columns, tessellation, tex_size
  tri_grid   optional: resolution and cap of build_scene_tri_grid, which
             feeds ray-traced GTAO
  probe_grid optional: margin and probe_y of frame.build_probe_grid, the
             octahedral probe grid that probe GI (enable_probes) reads
  band       optional: ranks and backend of the band frame
             (parallel/band.render_frame_banded), one rank per card
Besides these, a configuration names itself (name, source, reduced,
chips, why). build() refuses any other key, another scene kind, and a
render setting the harness does not build for (probe GI without a
probe_grid, or a probe_grid without probe GI; ray-traced GTAO without a
tri_grid), so that a cell runs what its file states.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch

from harness import standin


@dataclasses.dataclass
class Built:
    cfg: object            # vkr_tpu_torch.config.RenderConfig
    scene: object          # SceneDevice
    ssr_res: object
    tri_grid: object       # TriGrid or None
    scene_load_s: float
    probe_grid: object = None      # ProbeGrid or None
    probe_grid_s: float = None     # its build alone, synchronised


def render_config(config: dict):
    from vkr_tpu_torch.config import RenderConfig

    return RenderConfig.from_json(json.dumps(config["render"]))


@contextlib.contextmanager
def _assets(root):
    """VKR_ASSETS pointing at root while the scene loads."""
    old = os.environ.get("VKR_ASSETS")
    os.environ["VKR_ASSETS"] = root
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VKR_ASSETS", None)
        else:
            os.environ["VKR_ASSETS"] = old


def write_inputs(config: dict, seed: int, tmp: str) -> "str | None":
    """The raw files the configuration's scene reads, written from the
    seed under tmp: the Sponza stand-in's directory, or None."""
    if config["scene"]["kind"] != "sponza_colonnade":
        return None
    root = os.path.join(tmp, "assets")
    standin.write_sponza_standin(
        root, seed=seed, size_scale=config["scene"].get("standin_scale", 1.0))
    return root


CONFIG_KEYS = {"name", "source", "reduced", "chips", "why", "scene", "render",
               "tri_grid", "band", "probe_grid"}
PROBE_GRID_KEYS = {"margin", "probe_y"}
SCENE_KINDS = {"colonnade": {"kind", "columns", "tessellation", "tex_size"},
               "sponza_colonnade": {"kind", "columns", "tessellation",
                                    "tex_size", "standin_scale"}}


def honoured(config: dict):
    """Raise ValueError naming what of the configuration build() would not
    run as stated."""
    extra = set(config) - CONFIG_KEYS
    if extra:
        raise ValueError(f"configuration keys the harness does not run: "
                         f"{sorted(extra)}")
    sc = config["scene"]
    if sc.get("kind") not in SCENE_KINDS:
        raise ValueError(f"scene kind {sc.get('kind')!r}")
    if set(sc) - SCENE_KINDS[sc["kind"]]:
        raise ValueError(f"scene keys the harness does not run: "
                         f"{sorted(set(sc) - SCENE_KINDS[sc['kind']])}")
    r = config["render"]
    if r.get("enable_probes") and "probe_grid" not in config:
        raise ValueError("enable_probes without a probe_grid entry renders "
                         "the probeless frame")
    if "probe_grid" in config:
        if not r.get("enable_probes"):
            raise ValueError("a probe_grid entry without enable_probes: the "
                             "frame would not read the grid")
        if set(config["probe_grid"]) != PROBE_GRID_KEYS:
            raise ValueError(f"probe_grid keys {sorted(config['probe_grid'])}"
                             f", not {sorted(PROBE_GRID_KEYS)}")
    if r.get("gtao", {}).get("use_ray_query") and "tri_grid" not in config:
        raise ValueError("gtao.use_ray_query without a tri_grid entry "
                         "renders the MIS frame")


def build(config: dict, assets_root, device, sync) -> Built:
    """Scene, upload, probe grid, LUTs and scene grid on `device`, timed to
    the end of their device work (sync()); the probe grid is also timed
    alone."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene import procedural

    honoured(config)
    cfg = render_config(config)
    sc = config["scene"]
    t0 = time.perf_counter()
    args = dict(columns=sc["columns"], tessellation=sc["tessellation"],
                tex_size=sc["tex_size"])
    if sc["kind"] == "sponza_colonnade":
        with _assets(assets_root):
            scene_cpu = procedural.sponza_colonnade_scene(**args)
    elif sc["kind"] == "colonnade":
        scene_cpu = procedural.colonnade_scene(**args)
    else:
        raise ValueError(f"scene kind {sc['kind']!r}")
    scene = upload_scene(scene_cpu, device)
    probe_grid = probe_grid_s = None
    if "probe_grid" in config:
        sync()
        t_grid = time.perf_counter()
        probe_grid = frame.build_probe_grid(scene_cpu, cfg, device=device,
                                            **config["probe_grid"])
        sync()
        probe_grid_s = time.perf_counter() - t_grid
    ssr_res = frame.build_ssr_resources(cfg.ssr.lut_size, device=device)
    tri_grid = None
    if "tri_grid" in config:
        tg = config["tri_grid"]
        tri_grid = frame.build_scene_tri_grid(
            scene_cpu, resolution=tg["resolution"], cap=tg["cap"],
            device=device)
    sync()
    return Built(cfg=cfg, scene=scene, ssr_res=ssr_res, tri_grid=tri_grid,
                 scene_load_s=time.perf_counter() - t0,
                 probe_grid=probe_grid, probe_grid_s=probe_grid_s)


def initial_state(cfg, device):
    from vkr_tpu_torch.core.framestate import FrameState

    return FrameState.initial(cfg.height, cfg.width, device)


def camera(cfg, view, prev_view, k, device, jitter=True):
    from vkr_tpu_torch import frame

    return frame.camera_frame(cfg, view, prev_view, k, device,
                              use_jitter=jitter)


class FnRuns:
    """fn counting its runs: a captured frame runs fn at its warm-up and at
    each capture, and a replay runs nothing of it."""

    def __init__(self, fn):
        self.fn, self.runs = fn, 0

    def __call__(self, *args):
        self.runs += 1
        return self.fn(*args)


def frame_fn(built: Built, group=None, device=None):
    """The frame the window drives: render_frame, or with a process group
    the band frame over it."""
    from vkr_tpu_torch import frame

    if group is None:
        return FnRuns(lambda s, st, c: frame.render_frame(
            s, st, c, built.ssr_res, built.cfg, tri_grid=built.tri_grid,
            probe_grid=built.probe_grid))
    from vkr_tpu_torch.parallel import band

    return FnRuns(lambda s, st, c: band.render_frame_banded(
        s, st, c, built.ssr_res, built.cfg, group, device=device,
        tri_grid=built.tri_grid, probe_grid=built.probe_grid))


def captured(name, fn, built, state, cam):
    """cached_jit over fn with the FrameState donated: the timed path."""
    from vkr_tpu_torch.core.aot import cached_jit

    return cached_jit(name, fn, (built.scene, state, cam), donate_argnums=(1,))


def call(render, built, state, cam):
    """One frame through the captured frame; a BinOverflow is counted by
    the caller, which goes on as the port's tools do (call_or_recapture).
    Returns (colour, state, aux, overflowed)."""
    from vkr_tpu_torch.core.aot import BinOverflow, call_or_recapture

    try:
        colour, state, aux = render(built.scene, state, cam)
        return colour, state, aux, False
    except BinOverflow:
        colour, state, aux = call_or_recapture(render, built.scene, state,
                                               cam)
        return colour, state, aux, True


def state_tensors(state) -> dict:
    from harness.check import STATE_FIELDS

    return {k: getattr(state, k) for k in STATE_FIELDS}


@contextlib.contextmanager
def recording_gathers(log):
    """Record each window-gather wrapper call's shapes into log as
    (wrapper, image shapes, offset shapes, radius) while the block runs."""
    from vkr_tpu_torch.raster import gather_kernel

    from harness.work import WRAPPERS

    saved = {n: getattr(gather_kernel, n) for n in WRAPPERS}

    def wrap(name, fn):
        n_img = 2 if name == "taa_history_gather" else 1

        def rec(*args, **kw):
            log.append((name, [tuple(a.shape) for a in args[:n_img]],
                        [tuple(a.shape) for a in args[n_img:n_img + 2]],
                        kw.get("radius", 16)))
            return fn(*args, **kw)
        return rec

    for n, fn in saved.items():
        setattr(gather_kernel, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(gather_kernel, n, fn)


def _rigid_inverse(view):
    """The inverse of a rigid view matrix, [R^T | -R^T t], on its device."""
    r, t = view[:3, :3], view[:3, 3]
    top = torch.cat([r.T, (-r.T @ t)[:, None]], 1)
    return torch.cat([top, torch.eye(4, dtype=view.dtype,
                                     device=view.device)[3:]], 0)


def segment_ms(built, state, cam, reps, device):
    """Device ms of the frame's segments, each captured alone by cached_jit
    (the G-buffer through registry "gbuf_opaque_taa", frame.frame_mid,
    frame.frame_tail; with a probe grid also the probe trace through
    registry "trace_probe" on the frame's half-res depth and normals) and
    replayed `reps` times back to back between two CUDA events."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.core import registry
    from vkr_tpu_torch.core.aot import cached_jit

    cfg, ssr_res, grid = built.cfg, built.ssr_res, built.tri_grid
    probes = built.probe_grid
    jit_gbuf = cached_jit("bench_gbuffer", lambda s, c: registry.get(
        "gbuf_opaque_taa")(
            s, c.mvp, c.prev_mvp, c.jitter, width=cfg.width,
            height=cfg.height, quantize=cfg.quantize_formats,
            mask_peel_layers=cfg.raster.mask_peel_layers,
            trilinear=cfg.trilinear_textures), (built.scene, cam))
    gbuf = jit_gbuf(built.scene, cam)
    jit_mid = cached_jit("bench_mid", lambda gb, st, c: frame.frame_mid(
        gb, st, c, ssr_res, cfg, tri_grid=grid, probe_grid=probes),
        (gbuf, state, cam))
    mid = jit_mid(gbuf, state, cam)
    jit_tail = cached_jit("bench_tail", lambda gb, m, st, c: frame.frame_tail(
        gb, m, st, c, ssr_res, cfg), (gbuf, mid, state, cam))
    jit_tail(gbuf, mid, state, cam)
    segments = [("gbuffer", lambda: jit_gbuf(built.scene, cam)),
                ("ssr_gtao", lambda: jit_mid(gbuf, state, cam)),
                ("shade_taa", lambda: jit_tail(gbuf, mid, state, cam))]
    if probes is not None:
        hiz = registry.get("downsample_hiz")(gbuf.depth, gbuf.normal,
                                             gbuf.velocity)
        half = (hiz.mips[0], hiz.normal_half)
        jit_probe = cached_jit("bench_probe_trace", lambda d, n, c: (
            registry.get("trace_probe")(
                d, n, probes, _rigid_inverse(c.view), cfg.camera.fovy,
                cfg.aspect, cfg.camera.znear, cfg.camera.zfar)),
            (*half, cam))
        segments.append(("probe_trace", lambda: jit_probe(*half, cam)))
    out = {}
    for name, fn in segments:
        fn()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        out[name] = start.elapsed_time(end) / reps
    return out
