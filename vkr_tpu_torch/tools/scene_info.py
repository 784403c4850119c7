"""Scene inspection CLI (load_tinygltf_scene log analog, scene.cpp:347-352),
as vkr_tpu/tools/scene_info.py prints it.

    python -m vkr_tpu_torch.tools.scene_info /path/to/scene.gltf
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: python -m vkr_tpu_torch.tools.scene_info "
              "<scene.gltf>")
        return 1
    from vkr_tpu_torch.scene import load_gltf
    from vkr_tpu_torch.scene.scene import compile_scene

    g = load_gltf(args[0])
    print(f"meshes: {len(g.meshes)}  prims: "
          f"{sum(len(m) for m in g.meshes)}")
    print(f"materials: {len(g.materials)}  "
          f"masked: {sum(m.clip_alpha for m in g.materials)}")
    print(f"images: {len(g.images)}  textures: {len(g.texture_image)}")
    print(f"draw calls: {len(g.draw_calls)}  nodes: {len(g.nodes)}")

    s = compile_scene(g, tex_size=64)
    print(f"compiled: {s.num_triangles} triangles, "
          f"{len(s.positions)} vertices")
    if len(s.positions):
        lo = s.positions.min(axis=0)
        hi = s.positions.max(axis=0)
        print(f"bounds (model space): {np.round(lo, 3)} .. "
              f"{np.round(hi, 3)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
