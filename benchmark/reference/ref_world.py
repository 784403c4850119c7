"""The reference side of the comparison that decides `correct`.

Two references. The frozen plain renderer (vkr_ref) builds its own scene
from the raw inputs (the procedural geometry, the stand-in's PNG and
JPEG files), its own LUTs, scene grid and probe grid, and renders a
frame eagerly with every kernel's plain version. The independent chain
(plain_chain) judges the frame's image-space passes stage by stage, with
the frozen frame's SSR march outputs (`recording`) and the frozen
grid's cube faces. Neither imports anything of the
program or takes anything the program made.

Of the Sponza texture set the reference decodes only the textures a
colonnade material reads: the frame samples no other (the program
decodes all 69; the frames are the same).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os

import numpy as np
import torch

import plain_chain
import vkr_ref.passes  # noqa: F401  (registers every pass)
from vkr_ref import frame as ref_frame
from vkr_ref.config import RenderConfig
from vkr_ref.core import registry
from vkr_ref.core.framestate import FrameState
from vkr_ref.passes import probes as ref_probes
from vkr_ref.passes.gbuffer import upload_scene
from vkr_ref.scene import gltf as ref_gltf
from vkr_ref.scene import procedural, resample
from vkr_ref.scene.gltf import WRAP_REPEAT, GltfScene, Material
from vkr_ref.scene.scene import compile_scene

STANDIN_GLTF = os.path.join("Sponza", "glTF", "Sponza.gltf")


@dataclasses.dataclass
class World:
    cfg: RenderConfig
    scene: object
    ssr_res: object
    tri_grid: object
    world_tris: object = None     # (T, 3, 3) world-space triangles
    grid_size: tuple = None       # the grid's (resolution, cap)
    scene_cpu: object = None      # the CompiledScene, for a probe grid
    probe_args: dict = None       # the configuration's probe_grid entry
    probe_grid: object = None     # the frozen frame's ProbeGrid or None
    probe_faces: list = None      # its probes' (colour, distance) faces
    probe_bounds: tuple = None    # the grid's corners (min, max)


def _materials(doc):
    out = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        out.append(Material(
            albedo_tex=pbr.get("baseColorTexture", {}).get("index", -1),
            mr_tex=pbr.get("metallicRoughnessTexture", {}).get("index", -1),
            clip_alpha=m.get("alphaMode") == "MASK",
            alpha_cutoff=m.get("alphaCutoff", 0.5)))
    return out


def sponza_colonnade(assets_root, columns, tessellation, tex_size):
    """procedural.sponza_colonnade_scene over the stand-in, with only the
    textures the colonnade's six material slots read: decoded, resized
    and packed in their order of first use. Each material samples the
    same image as in the program's 69-texture table, so the frame is the
    same."""
    path = os.path.join(assets_root, STANDIN_GLTF)
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(path)
    materials = _materials(doc)
    texture_image = [t["source"] for t in doc.get("textures", [])]
    mask_ids = [i for i, m in enumerate(materials) if m.clip_alpha]
    solid_ids = [i for i, m in enumerate(materials)
                 if not m.clip_alpha and m.albedo_tex >= 0]
    remap = [solid_ids[i % len(solid_ids)] for i in range(5)]
    remap.append(mask_ids[0] if mask_ids else solid_ids[0])
    used = []                     # texture ids, in order of first use
    for m in remap:
        for t in (materials[m].albedo_tex, materials[m].mr_tex):
            if t >= 0 and t not in used:
                used.append(t)
    new_id = {t: i for i, t in enumerate(used)}
    images = []
    for t in used:
        with open(os.path.join(base, doc["images"][texture_image[t]]["uri"]),
                  "rb") as f:
            rgba = ref_gltf._decode_image(f.read())
        images.append(resample.pil_bilinear_resize(rgba, tex_size, tex_size))
    slots = [dataclasses.replace(
        materials[m], albedo_tex=new_id.get(materials[m].albedo_tex, -1),
        mr_tex=new_id.get(materials[m].mr_tex, -1)) for m in remap]
    geo = procedural.build_colonnade(columns, tessellation, tex_size, True, 0)
    scene = GltfScene(
        positions=geo.positions, normals=geo.normals, uvs=geo.uvs,
        indices=geo.indices, meshes=geo.meshes, materials=slots,
        images=images, texture_image=list(range(len(images))),
        texture_wrap=[WRAP_REPEAT] * len(images),
        draw_calls=geo.draw_calls, nodes=geo.nodes)
    return compile_scene(scene, tex_size=tex_size)


def judged(cfg: RenderConfig):
    """Raise ValueError where the independent chain would not judge the
    frame the configuration renders: it writes SSR, GTAO (MIS or
    ray-traced) and TAA, all on, probe GI on or off, and the shaded
    colour."""
    r = cfg
    missing = [k for k, on in (("enable_ssr", r.enable_ssr),
                               ("enable_gtao", r.enable_gtao),
                               ("enable_taa", r.enable_taa)) if not on]
    if missing or r.show_ao_only:
        raise ValueError(f"the independent chain judges the frame with SSR, "
                         f"GTAO and TAA on, shaded: {missing}")
    if not (r.gtao.mis or r.gtao.use_ray_query):
        raise ValueError("the independent chain has no plain GTAO main pass")
    if not (r.ssr.accumulate and r.ssr.use_blur and r.ssr.normalize_filter
            and r.ssr.bilateral_filter) or r.gtao.reflections_only:
        raise ValueError("the independent chain writes the default SSR "
                         "filter, blur and accumulation only")


def probe_bounds(scene_cpu, margin: float, probe_y: float) -> tuple:
    """The probe grid's corners over the scene's xz bounds, as
    frame.build_probe_grid places them (probe_renderer.cpp:290-384)."""
    pos = np.asarray(scene_cpu.positions, np.float32)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    return (np.array([lo[0] + margin, probe_y, lo[2] + margin], np.float32),
            np.array([hi[0] - margin, probe_y, hi[2] - margin], np.float32))


def probe_grid(world: World, device, faces: "list | None" = None):
    """The frozen frame's probe grid from its own scene: 6 cube faces a
    probe through K1's plain version, resampled and pyramided. faces, if
    given, receives each probe's (colour, distance) faces in grid
    order."""
    real = ref_probes.render_probe_cubemap

    def rec(*args, **kw):
        out = real(*args, **kw)
        faces.append((out[0], out[1]))
        return out

    if faces is not None:
        ref_probes.render_probe_cubemap = rec
    try:
        pg = world.probe_args
        return ref_frame.build_probe_grid(world.scene_cpu, world.cfg,
                                          margin=pg["margin"],
                                          probe_y=pg["probe_y"],
                                          device=device)
    finally:
        ref_probes.render_probe_cubemap = real


def build(config: dict, assets_root, device) -> World:
    cfg = RenderConfig.from_json(json.dumps(config["render"]))
    judged(cfg)
    sc = config["scene"]
    if sc["kind"] == "sponza_colonnade":
        scene_cpu = sponza_colonnade(assets_root, sc["columns"],
                                     sc["tessellation"], sc["tex_size"])
    elif sc["kind"] == "colonnade":
        scene_cpu = procedural.colonnade_scene(
            sc["columns"], sc["tessellation"], sc["tex_size"])
    else:
        raise ValueError(f"scene kind {sc['kind']!r}")
    tri_grid = world_tris = grid_size = None
    if "tri_grid" in config:
        tg = config["tri_grid"]
        tri_grid = ref_frame.build_scene_tri_grid(
            scene_cpu, resolution=tg["resolution"], cap=tg["cap"],
            device=device)
        # world space in float32, as the JAX package forms it
        pos = np.asarray(scene_cpu.positions, np.float32)
        m = np.asarray(scene_cpu.transforms, np.float32)[
            np.asarray(scene_cpu.vert_transform)]
        world = np.einsum("vij,vj->vi", m[:, :3, :3], pos) + m[:, :3, 3]
        world_tris = world[np.asarray(scene_cpu.tri_indices).reshape(-1, 3)]
        grid_size = (tg["resolution"], tg["cap"])
    world = World(cfg=cfg, scene=upload_scene(scene_cpu, device),
                  ssr_res=ref_frame.build_ssr_resources(cfg.ssr.lut_size,
                                                        device=device),
                  tri_grid=tri_grid, world_tris=world_tris,
                  grid_size=grid_size)
    if cfg.enable_probes:
        pg = config["probe_grid"]
        world.scene_cpu, world.probe_args = scene_cpu, pg
        world.probe_bounds = probe_bounds(scene_cpu, pg["margin"],
                                          pg["probe_y"])
        world.probe_faces = []
        world.probe_grid = probe_grid(world, device, world.probe_faces)
    return world


def initial_state(world: World, device) -> FrameState:
    return FrameState.initial(world.cfg.height, world.cfg.width, device)


def state_from(tensors: dict, device) -> FrameState:
    """A FrameState of the given tensors (field name -> tensor)."""
    return FrameState(**{k: torch.as_tensor(tensors[k]).to(device)
                         for k in FrameState.FIELDS})


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 matrix products in TF32, the
    nearest precision below the configuration's float32 with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def render(world: World, state: FrameState, view, prev_view, k: int,
           device, jitter: bool = True, grid=None):
    """Frame k: (colour, new state, aux) of the plain frame; grid: a probe
    grid in place of the world's."""
    cam = ref_frame.camera_frame(world.cfg, view, prev_view, k, device,
                                 use_jitter=jitter)
    with torch.no_grad():
        return ref_frame.render_frame(
            world.scene, state, cam, world.ssr_res, world.cfg,
            tri_grid=world.tri_grid,
            probe_grid=world.probe_grid if grid is None else grid)


@contextlib.contextmanager
def recording(march: dict):
    """While the block renders frozen frames, march[k] holds the SSR
    trace's outputs ("rays", "ssr_occ") of the frame rendered as frame k,
    k set through the function the block is given."""
    mod_name, qual = registry._REGISTRY["sssr_trace"]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, qual)
    at = {"frame": None}

    def rec(*args, **kw):
        out = real(*args, **kw)
        if at["frame"] is not None:
            march[at["frame"]] = dict(zip(("rays", "ssr_occ"), out))
        return out

    setattr(mod, qual, rec)
    try:
        yield lambda k: at.update(frame=k)
    finally:
        setattr(mod, qual, real)


class Independent:
    """The independent chain's side of one run: its own tables, and the
    judgement of one frame."""

    def __init__(self, world: World, device):
        self.world, self.device = world, device
        self.tables = plain_chain.Tables(world.cfg.ssr.lut_size, device)
        self.grid = None
        if world.world_tris is not None and world.cfg.gtao.use_ray_query:
            self.grid = plain_chain.Grid(world.world_tris, *world.grid_size,
                                         device)
        self.probes = None
        if world.probe_faces:
            c = world.cfg.probes
            self.probes = plain_chain.Probes(world.probe_faces,
                                             *world.probe_bounds, c.grid,
                                             c.oct_size, device)
        c = world.cfg
        tg = np.tan(np.float32(c.camera.fovy) / np.float32(2.0))
        proj = np.zeros((4, 4), np.float32)
        proj[0, 0] = 1.0 / (np.float32(c.aspect) * tg)
        proj[1, 1] = 1.0 / tg
        proj[2, 2] = c.camera.zfar / (c.camera.znear - c.camera.zfar)
        proj[2, 3] = -(c.camera.zfar * c.camera.znear) / (
            c.camera.zfar - c.camera.znear)
        proj[3, 2] = -1.0
        self.proj = proj

    def expected(self, frame: dict, state_in: dict, view, prev_view,
                 march: dict, frozen: dict, frozen_state: dict) -> dict:
        """{group: {name: tensor}} the chain expects of the frame."""
        cfg = self.world.cfg
        dev = self.device

        def t(a):
            return torch.as_tensor(a).to(dev)

        view = np.asarray(view, np.float32)
        mvp = self.proj @ view
        with torch.no_grad():
            return plain_chain.chain(
                {k: t(v) for k, v in frame.items()},
                {k: t(v) for k, v in state_in.items()},
                t(view), t(np.asarray(prev_view, np.float32)), t(mvp),
                {k: t(v) for k, v in march.items()}, cfg, self.tables,
                self.grid, {k: t(v) for k, v in frozen.items()},
                {k: t(v) for k, v in frozen_state.items()}, self.probes)
