"""Procedural benchmark scenes: the colonnade hall.

The same scenes as vkr_tpu.scene.procedural (array-for-array, same seed):
a Sponza-like hall of comparable workload — configurable up to Sponza
scale (colonnade_scene(columns=24, tessellation=80, tex_size=1024) has
314,988 triangles, 96 of them alpha-MASK foliage) — so the port renders
the raster/shading load the reference benches on; the same hall textured
with Sponza's own material and texture set (sponza_colonnade_scene,
bench.py's default workload); and vkr_tpu's two-masked-quads scene, where
the second alpha-MASK layer changes pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vkr_tpu_torch.scene.gltf import DrawCall, GltfScene, Material, Primitive
from vkr_tpu_torch.scene.scene import CompiledScene, compile_scene


def _uv_sphere(rings: int, sectors: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pp) * np.cos(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.sin(tt)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = pos.copy()
    uv = np.stack([tt / (2 * np.pi), pp / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    cols = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * cols + s
            idx += [[a, a + 1, a + cols], [a + 1, a + cols + 1, a + cols]]
    return pos, nrm, uv, np.asarray(idx, np.uint32).reshape(-1)


def _cylinder(sectors: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    ring = np.stack([np.cos(theta), np.zeros_like(theta), np.sin(theta)], -1)
    bottom = ring.copy()
    top = ring.copy()
    top[:, 1] = 1.0
    pos = np.concatenate([bottom, top]).astype(np.float32)
    nrm = np.concatenate([ring, ring]).astype(np.float32)
    nrm[:, 1] = 0
    u = theta / (2 * np.pi)
    uv = np.concatenate(
        [np.stack([u, np.zeros_like(u)], -1), np.stack([u, np.ones_like(u)], -1)]
    ).astype(np.float32)
    n = sectors + 1
    idx = []
    for s in range(sectors):
        idx += [[s, s + 1, s + n], [s + 1, s + n + 1, s + n]]
    return pos, nrm, uv, np.asarray(idx, np.uint32).reshape(-1)


def _quad() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    pos = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32
    )
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return pos, nrm, uv, idx


def _noise_texture(rng, size: int, base_color, kind: str) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    if kind == "checker":
        pat = ((xx // (size // 8) + yy // (size // 8)) % 2).astype(np.float32)
        pat = 0.6 + 0.4 * pat
    elif kind == "stripes":
        pat = 0.7 + 0.3 * np.sin(xx * 2 * np.pi * 6 / size) ** 2
    else:
        pat = 0.5 + 0.5 * rng.random((size, size)).astype(np.float32)
        # cheap blur for low-frequency noise
        for _ in range(2):
            pat = 0.25 * (
                np.roll(pat, 1, 0) + np.roll(pat, -1, 0)
                + np.roll(pat, 1, 1) + np.roll(pat, -1, 1)
            )
        pat = 0.5 + (pat - pat.mean()) * 2.0
    rgb = np.clip(
        pat[..., None] * np.asarray(base_color, np.float32)[None, None], 0, 1
    )
    out = np.zeros((size, size, 4), np.uint8)
    out[..., :3] = (rgb * 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def _leaf_texture(size: int) -> np.ndarray:
    """Alpha-MASK foliage analog: opaque blob with zero-alpha surround."""
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    r = np.sqrt(xx**2 + yy**2)
    inside = (r + 0.25 * np.sin(np.arctan2(yy, xx) * 5) < 0.8)
    out = np.zeros((size, size, 4), np.uint8)
    out[..., 1] = np.where(inside, 140, 0)
    out[..., 0] = np.where(inside, 60, 0)
    out[..., 2] = np.where(inside, 40, 0)
    out[..., 3] = np.where(inside, 255, 0)
    return out


def build_colonnade(
    columns: int = 6,
    tessellation: int = 24,
    tex_size: int = 256,
    foliage: bool = True,
    seed: int = 0,
) -> GltfScene:
    """A Sponza-like colonnade hall: stone floor, two rows of columns,
    sphere 'capitals', optional MASK-alpha foliage planes."""
    rng = np.random.default_rng(seed)

    geoms = []  # (pos, nrm, uv, idx, material, transform)
    quad = _quad()
    cyl = _cylinder(tessellation)
    sph = _uv_sphere(tessellation // 2, tessellation)

    def place(geom, material, scale, offset, uv_scale=1.0):
        pos, nrm, uv, idx = geom
        m = np.eye(4, dtype=np.float32)
        m[0, 0], m[1, 1], m[2, 2] = scale
        m[:3, 3] = offset
        geoms.append((pos, nrm, uv * uv_scale, idx, material, m))

    hall_l = max(8.0, columns * 2.5)
    place(quad, 0, (hall_l, 1, 6), (0, 0, 0), uv_scale=8.0)        # floor
    place(quad, 1, (hall_l, 1, 6), (0, 6, 0), uv_scale=8.0)        # ceiling
    # walls (rotated quads as thin boxes via two quads)
    wall = _quad()
    for zs in (-6.0, 6.0):
        m = np.eye(4, dtype=np.float32)
        geoms.append(
            (
                np.array([[-hall_l, 0, zs], [hall_l, 0, zs],
                          [hall_l, 6, zs], [-hall_l, 6, zs]], np.float32),
                np.tile(np.array([[0, 0, -np.sign(zs)]], np.float32), (4, 1)),
                np.array([[0, 0], [8, 0], [8, 3], [0, 3]], np.float32),
                np.array([0, 1, 2, 0, 2, 3], np.uint32),
                2,
                m,
            )
        )
    # end caps: the reference benches a fully-enclosed Sponza hall
    # (main.cpp:217-218) — open ends leak background and flatten
    # raster/shading cost (bench coverage 0.58 before)
    for xs in (-hall_l, hall_l):
        m = np.eye(4, dtype=np.float32)
        geoms.append(
            (
                np.array([[xs, 0, -6], [xs, 0, 6],
                          [xs, 6, 6], [xs, 6, -6]], np.float32),
                np.tile(np.array([[-np.sign(xs), 0, 0]], np.float32),
                        (4, 1)),
                np.array([[0, 0], [4, 0], [4, 2], [0, 2]], np.float32),
                np.array([0, 1, 2, 0, 2, 3], np.uint32),
                2,
                m,
            )
        )

    for i in range(columns):
        x = -hall_l * 0.8 + i * (1.6 * hall_l / max(columns - 1, 1))
        for z in (-3.5, 3.5):
            place(cyl, 3, (0.4, 5.0, 0.4), (x, 0, z), uv_scale=2.0)
            place(sph, 4, (0.6, 0.45, 0.6), (x, 5.2, z))

    if foliage:
        for i in range(columns * 2):
            x = rng.uniform(-hall_l * 0.8, hall_l * 0.8)
            z = rng.uniform(-5, 5)
            geoms.append(
                (
                    np.array([[-0.8, 0, 0], [0.8, 0, 0],
                              [0.8, 1.6, 0], [-0.8, 1.6, 0]], np.float32),
                    np.tile(np.array([[0, 0, 1]], np.float32), (4, 1)),
                    np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
                    np.array([0, 1, 2, 0, 2, 3], np.uint32),
                    5,
                    np.array(
                        [[np.cos(i), 0, -np.sin(i), x],
                         [0, 1, 0, rng.uniform(1.0, 4.0)],
                         [np.sin(i), 0, np.cos(i), z],
                         [0, 0, 0, 1]], np.float32,
                    ),
                )
            )

    # Assemble a GltfScene with one mesh per geom and one draw call each.
    positions, normals, uvs, indices = [], [], [], []
    meshes, draw_calls = [], []
    v_off = i_off = 0
    for mesh_id, (pos, nrm, uv, idx, material, m) in enumerate(geoms):
        positions.append(pos)
        normals.append(nrm)
        uvs.append(uv)
        indices.append(idx.astype(np.uint32))
        meshes.append(
            [Primitive(vertex_offset=v_off, index_offset=i_off,
                       index_count=len(idx), material=material)]
        )
        draw_calls.append(DrawCall(mesh=mesh_id, transform=m))
        v_off += len(pos)
        i_off += len(idx)

    materials = [
        Material(albedo_tex=0, mr_tex=6),
        Material(albedo_tex=1, mr_tex=6),
        Material(albedo_tex=2, mr_tex=6),
        Material(albedo_tex=3, mr_tex=7),
        Material(albedo_tex=4, mr_tex=7),
        Material(albedo_tex=5, mr_tex=6, clip_alpha=True),
    ]
    images = [
        _noise_texture(rng, tex_size, (0.75, 0.72, 0.68), "checker"),
        _noise_texture(rng, tex_size, (0.7, 0.68, 0.66), "noise"),
        _noise_texture(rng, tex_size, (0.72, 0.65, 0.55), "noise"),
        _noise_texture(rng, tex_size, (0.78, 0.75, 0.7), "stripes"),
        _noise_texture(rng, tex_size, (0.8, 0.78, 0.72), "noise"),
        _leaf_texture(tex_size),
        _noise_texture(rng, tex_size, (0.2, 0.55, 0.1), "noise"),   # MR: rough
        _noise_texture(rng, tex_size, (0.2, 0.25, 0.8), "noise"),   # MR: metal
    ]
    return GltfScene(
        positions=np.concatenate(positions).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        indices=np.concatenate(indices),
        meshes=meshes,
        materials=materials,
        images=images,
        texture_image=list(range(len(images))),
        texture_wrap=[0] * len(images),
        draw_calls=draw_calls,
        nodes=[],
    )


def colonnade_scene(
    columns: int = 6, tessellation: int = 24, tex_size: int = 256,
    foliage: bool = True, seed: int = 0,
) -> CompiledScene:
    return compile_scene(
        build_colonnade(columns, tessellation, tex_size, foliage, seed),
        tex_size=tex_size,
    )


def build_two_masked_quads(tex_size: int = 64) -> GltfScene:
    """Two stacked alpha-MASK quads in front of an opaque backdrop — the
    depth-peel test scene. The front quad's albedo has a transparent hole
    in the middle; the back quad is solid, so per-fragment discard
    semantics must reveal the BACK MASKED quad through the hole (not the
    backdrop)."""
    hole = np.full((tex_size, tex_size, 4), 255, np.uint8)
    hole[..., :3] = 180
    yy, xx = np.mgrid[0:tex_size, 0:tex_size]
    c = tex_size / 2.0
    hole[(xx - c) ** 2 + (yy - c) ** 2 < (tex_size * 0.3) ** 2, 3] = 0
    solid = np.full((tex_size, tex_size, 4), 255, np.uint8)
    solid[..., :3] = (40, 200, 40)
    back = np.full((tex_size, tex_size, 4), 255, np.uint8)
    back[..., :3] = (60, 60, 220)
    mr_a = np.full((tex_size, tex_size, 4), 255, np.uint8)
    mr_a[..., :3] = (0, 64, 32)
    mr_b = np.full((tex_size, tex_size, 4), 255, np.uint8)
    mr_b[..., :3] = (0, 192, 224)
    mr_c = np.full((tex_size, tex_size, 4), 255, np.uint8)
    mr_c[..., :3] = (0, 16, 128)

    def quad_at(z, s=2.0):
        pos = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]],
                       np.float32)
        nrm = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
        return pos, nrm, uv, idx

    geoms = [
        (quad_at(-1.0), 0),   # front masked (hole)
        (quad_at(0.5), 1),    # back masked (solid)
        (quad_at(2.0, 4.0), 2),  # opaque backdrop
    ]
    positions, normals, uvs, indices = [], [], [], []
    meshes, draw_calls = [], []
    v_off = i_off = 0
    for mesh_id, ((pos, nrm, uv, idx), material) in enumerate(geoms):
        positions.append(pos)
        normals.append(nrm)
        uvs.append(uv)
        indices.append(idx)
        meshes.append(
            [Primitive(vertex_offset=v_off, index_offset=i_off,
                       index_count=len(idx), material=material)]
        )
        draw_calls.append(
            DrawCall(mesh=mesh_id, transform=np.eye(4, dtype=np.float32))
        )
        v_off += len(pos)
        i_off += len(idx)

    return GltfScene(
        positions=np.concatenate(positions).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        indices=np.concatenate(indices),
        meshes=meshes,
        materials=[
            Material(albedo_tex=0, mr_tex=3, clip_alpha=True),
            Material(albedo_tex=1, mr_tex=4, clip_alpha=True),
            Material(albedo_tex=2, mr_tex=5),
        ],
        images=[hole, solid, back, mr_a, mr_b, mr_c],
        texture_image=list(range(6)),
        texture_wrap=[0] * 6,
        draw_calls=draw_calls,
        nodes=[],
    )


def two_masked_quads_scene(tex_size: int = 64) -> CompiledScene:
    return compile_scene(build_two_masked_quads(tex_size),
                         tex_size=tex_size)


# vkr_tpu reads Sponza from the reference renderer's assets
# (vkr_tpu/scene/procedural.py:331); the port resolves the same file under
# $VKR_ASSETS (scene/assets.py)
SPONZA_ASSET = "Sponza/glTF/Sponza.gltf"


def sponza_texture_set(tex_size: int = 512):
    """Sponza's 25-material / 69-texture set from the reference's glTF
    (its geometry blob is stripped; the helper reads only the material
    table and the image files), as vkr_tpu's sponza_texture_set reads it:
    images in `images` order through the port's own decoders (PIL's
    convert("RGBA") bytes), each resized with Pillow's BILINEAR
    (scene/resample.py) to tex_size² unless it is that size already;
    texture -> image from `textures[*].source`; materials from
    pbrMetallicRoughness with MASK alpha and alphaCutoff (default 0.5);
    every sampler REPEAT. Returns (materials, images, texture_image,
    texture_wrap) for build_colonnade. Each decode and each resize is a
    start-up span (core/graph.py), "decode" and "resize"."""
    import json
    import os

    from vkr_tpu_torch.core.graph import span
    from vkr_tpu_torch.scene import gltf as _gltf
    from vkr_tpu_torch.scene import resample
    from vkr_tpu_torch.scene.assets import asset_path
    from vkr_tpu_torch.scene.gltf import WRAP_REPEAT

    path = asset_path(SPONZA_ASSET, "sponza")
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(path)
    images = []
    for img in doc.get("images", []):
        with open(os.path.join(base, img["uri"]), "rb") as f:
            rgba = _gltf._decode_image(f.read())
        with span("resize", startup=True):
            images.append(resample.pil_bilinear_resize(rgba, tex_size,
                                                       tex_size))
    texture_image = [t["source"] for t in doc.get("textures", [])]
    materials = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        materials.append(Material(
            albedo_tex=pbr.get("baseColorTexture", {}).get("index", -1),
            mr_tex=pbr.get("metallicRoughnessTexture", {}).get("index",
                                                               -1),
            clip_alpha=m.get("alphaMode") == "MASK",
            alpha_cutoff=m.get("alphaCutoff", 0.5),
        ))
    return materials, images, texture_image, [WRAP_REPEAT] * len(images)


def sponza_colonnade_scene(
    columns: int = 24, tessellation: int = 80, tex_size: int = 512,
    foliage: bool = True, seed: int = 0,
) -> CompiledScene:
    """bench.py's default workload: colonnade geometry at Sponza-like
    triangle counts (314,988 at the defaults) textured with Sponza's
    25-material / 69-texture set. The colonnade's 6 material slots map
    onto Sponza's materials as vkr_tpu maps them: the 5 solid slots onto
    the first solid materials with an albedo texture, in turn, and the
    foliage onto the first MASK material."""
    scene = build_colonnade(columns, tessellation, tex_size, foliage, seed)
    materials, images, texture_image, wrap = sponza_texture_set(tex_size)
    mask_ids = [i for i, m in enumerate(materials) if m.clip_alpha]
    solid_ids = [i for i, m in enumerate(materials)
                 if not m.clip_alpha and m.albedo_tex >= 0]
    remap = [solid_ids[i % len(solid_ids)] for i in range(5)]
    remap.append(mask_ids[0] if mask_ids else solid_ids[0])
    meshes = [
        [Primitive(vertex_offset=p.vertex_offset,
                   index_offset=p.index_offset,
                   index_count=p.index_count,
                   material=remap[p.material])
         for p in prims]
        for prims in scene.meshes
    ]
    scene = GltfScene(
        positions=scene.positions, normals=scene.normals, uvs=scene.uvs,
        indices=scene.indices, meshes=meshes, materials=materials,
        images=images, texture_image=texture_image, texture_wrap=wrap,
        draw_calls=scene.draw_calls, nodes=scene.nodes,
    )
    return compile_scene(scene, tex_size=tex_size)
