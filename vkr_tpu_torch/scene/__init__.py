from vkr_tpu_torch.scene.gltf import GltfScene, Material, Primitive, DrawCall
from vkr_tpu_torch.scene.scene import (
    CompiledScene,
    compile_scene,
    build_mip_pyramid,
)
from vkr_tpu_torch.scene.procedural import colonnade_scene, build_colonnade
from vkr_tpu_torch.scene.orbit import bench_orbit_view
