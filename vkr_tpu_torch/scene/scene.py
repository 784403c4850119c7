"""Scene compilation: glTF -> host-side SoA arrays (numpy).

The analog of the reference's CompiledScene (scene/scene.hpp:63-87): one
merged vertex pool + index pool, material table, texture set. Instances
are flattened at compile time (per-vertex transform index), and the
bindless texture array becomes a fixed-size RGBA8 texture array with a
full mip pyramid; with native_sizes=True each texture also keeps its own
resolution and aspect. passes/gbuffer.upload_scene moves it to the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from vkr_tpu_torch import native
from vkr_tpu_torch.core.graph import span
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
    # Texture array mip pyramid: tuple of (NT, S>>l, S>>l, 4) u8; None in
    # native-size mode, where upload_scene packs tex_images instead (vkr_tpu
    # builds both; the port skips the resizes it would not read)
    tex_mips: "Tuple[np.ndarray, ...] | None"
    tex_wrap: np.ndarray       # (NT,) i32 (gltf.WRAP_*)
    # native-size mode (compile_scene(native_sizes=True)): per-texture
    # images at their own resolution and aspect (scene.cpp:104-161
    # samples each texture at native size); None in uniform mode
    tex_images: "tuple | None" = None

    @property
    def num_triangles(self) -> int:
        return self.tri_indices.shape[0]


def build_mip_pyramid(tex_array: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(NT, S, S, 4) u8 -> tuple of mips down to 1x1 via 2x2 box filter
    with round-half-up (the reference's vkCmdBlitImage linear mip-gen,
    scene/images.cpp:93+), through the native asset pipeline, as vkr_tpu
    builds it when its library is built."""
    mips = [tex_array]
    cur = tex_array
    while cur.shape[1] > 1:
        cur = native.mip_downsample_rgba8(cur)
        mips.append(cur)
    return tuple(mips)


def build_mip_pyramid_plain(tex_array: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Plain numpy version of build_mip_pyramid."""
    mips = [tex_array]
    cur = tex_array.astype(np.uint16)
    while cur.shape[1] > 1:
        n, s, _, c = cur.shape
        cur = (
            cur.reshape(n, s // 2, 2, s // 2, 2, c).sum(axis=(2, 4)) + 2
        ) // 4
        mips.append(cur.astype(np.uint8))
    return tuple(mips)


def _resize_rgba(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear (H, W, 4) u8 -> (size, size, 4) u8 through the native asset
    pipeline (native/asset_pipeline.cpp resize_rgba8), as vkr_tpu resizes
    when its library is built. (vkr_tpu falls back to PIL's antialiased
    BILINEAR when it is not; the two differ.)"""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return native.resize_rgba8(img, size, size)


def _resize_rgba_plain(img: np.ndarray, size: int) -> np.ndarray:
    """Plain numpy version of _resize_rgba, as the library computes it
    under -O3 -march=native on an x86-64 with FMA: half-texel centres in
    float32, clamp to edge, each lerp one fma, + 0.5, clamp to [0, 255],
    truncate."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    f32 = np.float32

    def taps(n_src, n_dst):
        i = np.arange(n_dst)
        f = (i.astype(f32) + f32(0.5)) * f32(n_src) / f32(n_dst) - f32(0.5)
        i0 = np.floor(f).astype(np.int64)
        t = f - i0.astype(f32)
        return np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), t

    y0, y1, ty = taps(h, size)
    x0, x1, tx = taps(w, size)
    src = img.astype(np.int32)
    p00, p01 = src[y0][:, x0], src[y0][:, x1]
    p10, p11 = src[y1][:, x0], src[y1][:, x1]
    tx = tx[None, :, None]
    top = native.fma32((p01 - p00).astype(f32), tx, p00.astype(f32))
    bot = native.fma32((p11 - p10).astype(f32), tx, p10.astype(f32))
    v = native.fma32(bot - top, ty[:, None, None], top)
    return np.clip(v + f32(0.5), f32(0), f32(255)).astype(np.uint8)


def _native_image(img: np.ndarray, tex_size: int) -> np.ndarray:
    """An image at its own size, downscaled by the integer factor that
    brings its longer edge to tex_size or below (aspect preserved, box
    mean truncated)."""
    img = np.asarray(img, np.uint8)
    f = -(-max(img.shape[0], img.shape[1]) // tex_size)
    if f > 1:
        h2 = max(img.shape[0] // f, 1)
        w2 = max(img.shape[1] // f, 1)
        img = img[: h2 * f, : w2 * f].reshape(
            h2, f, w2, f, 4).astype(np.uint32).mean(
            axis=(1, 3)).astype(np.uint8)
    return np.ascontiguousarray(img)


def compile_scene(
    scene: _gltf.GltfScene, tex_size: int = 256,
    native_sizes: bool = False,
) -> CompiledScene:
    """tex_size: the uniform square texture size every image is resized
    to; with native_sizes=True also the MAX edge of tex_images, where
    larger textures downscale by integer factors, aspect preserved, and
    everything else keeps its own resolution, like the reference's
    per-texture images."""
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
    tex_images = tex_mips = None
    # the textures' resizes and mips: a start-up span (core/graph.py)
    with span("resize", startup=True):
        if native_sizes:
            tex_images = []
            for t in range(max(n_tex, 1)):
                img_id = scene.texture_image[t] if t < n_tex else -1
                if 0 <= img_id < len(scene.images):
                    tex_images.append(_native_image(scene.images[img_id],
                                                    tex_size))
                else:
                    tex_images.append(np.full((1, 1, 4), 255, np.uint8))
            tex_images = tuple(tex_images)
        else:
            tex_array = np.zeros((max(n_tex, 1), tex_size, tex_size, 4),
                                 np.uint8)
            tex_array[..., 3] = 255
            for t, img_id in enumerate(scene.texture_image):
                if 0 <= img_id < len(scene.images):
                    tex_array[t] = _resize_rgba(scene.images[img_id], tex_size)
            tex_mips = build_mip_pyramid(tex_array)

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
        tex_mips=tex_mips,
        tex_wrap=np.asarray(scene.texture_wrap or [0], np.int32),
        tex_images=tex_images,
    )


def load_scene(path: str, tex_size: int = 256,
               native_sizes: bool = False) -> CompiledScene:
    """load_tinygltf_scene analog (scene.cpp:330-360): a glTF file on disk
    -> CompiledScene."""
    return compile_scene(_gltf.load_gltf(path), tex_size=tex_size,
                         native_sizes=native_sizes)
