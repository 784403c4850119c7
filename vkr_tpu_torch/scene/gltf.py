"""glTF scene containers (the loader itself is a later slice).

The same dataclasses as vkr_tpu.scene.gltf, which mirror the reference's
tiny_gltf-based loader (scene/scene.cpp:330-360): meshes merged into one
vertex/index pool, materials with albedo/metallic-roughness texture
indices + alpha-MASK flag, node hierarchy flattened to per-draw-call
transforms.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

WRAP_REPEAT = 0
WRAP_CLAMP = 1


@dataclasses.dataclass
class Primitive:
    """Mirrors reference scene.hpp:21-26."""

    vertex_offset: int
    index_offset: int
    index_count: int
    material: int


@dataclasses.dataclass
class Material:
    """Mirrors reference scene/scene.cpp:171-181."""

    albedo_tex: int = -1      # texture index or -1
    mr_tex: int = -1
    clip_alpha: bool = False  # alphaMode == MASK
    alpha_cutoff: float = 0.5


@dataclasses.dataclass
class DrawCall:
    mesh: int
    transform: np.ndarray  # (4, 4) world matrix


@dataclasses.dataclass
class GltfScene:
    positions: np.ndarray   # (V, 3) f32
    normals: np.ndarray     # (V, 3) f32
    uvs: np.ndarray         # (V, 2) f32
    indices: np.ndarray     # (I,) u32 (relative to prim vertex_offset)
    meshes: List[List[Primitive]]
    materials: List[Material]
    images: List[np.ndarray]       # decoded RGBA8 (H, W, 4) u8
    texture_image: List[int]       # texture -> image index
    texture_wrap: List[int]        # texture -> WRAP_*
    draw_calls: List[DrawCall]
    nodes: List[dict]              # raw node dicts (for animation later)
