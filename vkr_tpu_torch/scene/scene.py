"""Scene compilation: glTF -> host-side SoA arrays (numpy).

The analog of the reference's CompiledScene (scene/scene.hpp:63-87): one
merged vertex pool + index pool, material table, texture set. Instances
are flattened at compile time (per-vertex transform index), and the
bindless texture array becomes a fixed-size RGBA8 texture array with a
full mip pyramid. passes/gbuffer.upload_scene moves it to the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from vkr_tpu_torch.mathlib.transforms import normal_matrix
from vkr_tpu_torch.scene import gltf as _gltf


class CompiledScene(NamedTuple):
    # Geometry (instance-expanded, model space)
    positions: np.ndarray      # (V, 3) f32
    normals: np.ndarray        # (V, 3) f32
    uvs: np.ndarray            # (V, 2) f32
    tri_indices: np.ndarray    # (T, 3) i32 absolute vertex ids
    tri_material: np.ndarray   # (T,) i32, -1 = fallback material
    vert_transform: np.ndarray  # (V,) i32 -> transforms row
    # Per-draw-call transforms
    transforms: np.ndarray     # (N, 4, 4) f32 world matrices
    normal_mats: np.ndarray    # (N, 4, 4) f32
    # Material SoA (reference scene.cpp:171-181)
    mat_albedo_tex: np.ndarray   # (M,) i32, -1 = none
    mat_mr_tex: np.ndarray       # (M,) i32
    mat_clip_alpha: np.ndarray   # (M,) i32 0/1
    mat_alpha_cutoff: np.ndarray  # (M,) f32
    # Texture array mip pyramid: tuple of (NT, S>>l, S>>l, 4) u8
    tex_mips: Tuple[np.ndarray, ...]
    tex_wrap: np.ndarray       # (NT,) i32 (gltf.WRAP_*)

    @property
    def num_triangles(self) -> int:
        return self.tri_indices.shape[0]


def build_mip_pyramid(tex_array: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(NT, S, S, 4) u8 -> tuple of mips down to 1x1 via 2x2 box filter
    with round-half-up (the reference's vkCmdBlitImage linear mip-gen,
    scene/images.cpp:93+)."""
    mips = [tex_array]
    cur = tex_array.astype(np.uint16)
    while cur.shape[1] > 1:
        n, s, _, c = cur.shape
        cur = (
            cur.reshape(n, s // 2, 2, s // 2, 2, c).sum(axis=(2, 4)) + 2
        ) // 4
        mips.append(cur.astype(np.uint8))
    return tuple(mips)


def compile_scene(scene: _gltf.GltfScene, tex_size: int = 256
                  ) -> CompiledScene:
    """tex_size: the uniform square texture size. Images must already be
    tex_size x tex_size (the colonnade's are); resizing arrives with the
    glTF loader."""
    positions, normals, uvs = [], [], []
    tri_indices, tri_material, vert_transform = [], [], []
    transforms, normal_mats = [], []
    v_base = 0

    for draw_id, dc in enumerate(scene.draw_calls):
        transforms.append(dc.transform.astype(np.float32))
        normal_mats.append(normal_matrix(dc.transform))
        for prim in scene.meshes[dc.mesh]:
            idx = scene.indices[
                prim.index_offset : prim.index_offset + prim.index_count
            ].astype(np.int64)
            n_verts = int(idx.max()) + 1 if len(idx) else 0
            sl = slice(prim.vertex_offset, prim.vertex_offset + n_verts)
            positions.append(scene.positions[sl])
            normals.append(scene.normals[sl])
            uvs.append(scene.uvs[sl])
            vert_transform.append(np.full(n_verts, draw_id, np.int32))
            tri = (idx.reshape(-1, 3) + v_base).astype(np.int32)
            tri_indices.append(tri)
            tri_material.append(
                np.full(len(tri), prim.material, np.int32)
            )
            v_base += n_verts

    n_tex = len(scene.texture_image)
    tex_array = np.zeros((max(n_tex, 1), tex_size, tex_size, 4), np.uint8)
    tex_array[..., 3] = 255
    for t, img_id in enumerate(scene.texture_image):
        if 0 <= img_id < len(scene.images):
            img = scene.images[img_id]
            if img.shape[:2] != (tex_size, tex_size):
                raise ValueError(
                    f"image {img_id} is {img.shape[:2]}, expected "
                    f"{tex_size}x{tex_size}: texture resizing comes with "
                    "the glTF loader (ROADMAP queue 1 item 13)")
            tex_array[t] = img

    materials = scene.materials or [_gltf.Material()]

    def cat(parts, shape, dtype):
        if parts and sum(len(p) for p in parts):
            return np.concatenate(parts, axis=0).astype(dtype)
        return np.zeros(shape, dtype)

    return CompiledScene(
        positions=cat(positions, (0, 3), np.float32),
        normals=cat(normals, (0, 3), np.float32),
        uvs=cat(uvs, (0, 2), np.float32),
        tri_indices=cat(tri_indices, (0, 3), np.int32),
        tri_material=cat(tri_material, (0,), np.int32),
        vert_transform=cat(vert_transform, (0,), np.int32),
        transforms=np.stack(transforms) if transforms else np.eye(
            4, dtype=np.float32)[None],
        normal_mats=np.stack(normal_mats) if normal_mats else np.eye(
            4, dtype=np.float32)[None],
        mat_albedo_tex=np.array(
            [m.albedo_tex for m in materials], np.int32
        ),
        mat_mr_tex=np.array([m.mr_tex for m in materials], np.int32),
        mat_clip_alpha=np.array(
            [int(m.clip_alpha) for m in materials], np.int32
        ),
        mat_alpha_cutoff=np.array(
            [m.alpha_cutoff for m in materials], np.float32
        ),
        tex_mips=build_mip_pyramid(tex_array),
        tex_wrap=np.asarray(scene.texture_wrap or [0], np.int32),
    )
