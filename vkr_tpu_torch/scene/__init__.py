from vkr_tpu_torch.scene.gltf import (GltfScene, Material, Primitive,
                                      DrawCall, load_gltf)
from vkr_tpu_torch.scene.scene import (
    CompiledScene,
    compile_scene,
    build_mip_pyramid,
    load_scene,
)
from vkr_tpu_torch.scene.procedural import colonnade_scene, build_colonnade
from vkr_tpu_torch.scene.orbit import bench_orbit_view
from vkr_tpu_torch.scene.camera import Camera
