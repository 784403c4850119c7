"""Carry state across from vkr_tpu, so both packages render from identical
inputs.

vkr_tpu's CompiledScene is a NamedTuple of numpy arrays and its FrameState
holds arrays that numpy can read; nothing here imports jax or vkr_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from vkr_tpu_torch.core.framestate import FrameState
from vkr_tpu_torch.passes.gbuffer import SceneDevice, upload_scene
from vkr_tpu_torch.scene.scene import CompiledScene


def scene_from_numpy(compiled_scene, device) -> SceneDevice:
    """vkr_tpu CompiledScene (any object with its fields as numpy arrays,
    tex_images too when it has them) -> the port's uploaded scene on
    `device`."""
    fields = {f: getattr(compiled_scene, f, None)
              for f in CompiledScene._fields}
    return upload_scene(CompiledScene(**fields), device)


def ssr_resources_from_numpy(resources, device):
    """vkr_tpu's SSRResources (pdf_lut, brdf_lut, halton: any arrays numpy
    can read) -> the port's frame.SSRResources on `device`."""
    from vkr_tpu_torch.frame import SSRResources

    return SSRResources(**{
        name: torch.as_tensor(np.array(getattr(resources, name), np.float32),
                              device=device)
        for name in SSRResources._fields})


def probe_grid_from_numpy(grid, device):
    """vkr_tpu's ProbeGrid (arrays numpy can read, the mip tables and the
    grid size) -> the port's passes.probes.ProbeGrid on `device`."""
    from vkr_tpu_torch.passes.probes import ProbeGrid

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ProbeGrid(
        colors=t(grid.colors), depth_flat=t(grid.depth_flat),
        mip_offsets=tuple(int(o) for o in grid.mip_offsets),
        mip_sizes=tuple(int(s) for s in grid.mip_sizes),
        probe_min=t(grid.probe_min), probe_max=t(grid.probe_max),
        grid_size=int(grid.grid_size))


def tri_grid_from_numpy(grid, device):
    """vkr_tpu's TriGrid (tri_verts, cell_tris, grid_min, cell_size: arrays
    numpy can read; dims, cap, overflowed: ints) -> the port's
    scene.accel.TriGrid on `device`."""
    from vkr_tpu_torch.scene.accel import TriGrid

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    return TriGrid(
        tri_verts=t(grid.tri_verts, np.float32),
        cell_tris=t(grid.cell_tris, np.int32),
        grid_min=t(grid.grid_min, np.float32),
        cell_size=t(grid.cell_size, np.float32),
        dims=tuple(int(n) for n in grid.dims), cap=int(grid.cap),
        overflowed=int(grid.overflowed))


def framestate_from_numpy(state_arrays, device) -> FrameState:
    """FrameState from a mapping or object with FrameState's fields as
    arrays (vkr_tpu's FrameState, or framestate_to_numpy's dict). A batch
    of views (vkr_tpu's parallel.sharding.batch_states: every field with a
    leading view axis, frame_index (V,)) becomes the port's batched
    FrameState (parallel.sharding.batch_states). frame_index is int32,
    the other fields float32."""
    def get(name):
        if isinstance(state_arrays, dict):
            return state_arrays[name]
        return getattr(state_arrays, name)

    return FrameState(**{
        name: torch.as_tensor(
            np.array(get(name), np.int32 if name == "frame_index"
                     else np.float32), device=device)
        for name in FrameState.FIELDS})


def framestate_to_numpy(state: FrameState) -> dict:
    """FrameState -> dict of numpy arrays (frame_index int32, 0-d, or (V,)
    for a batched FrameState)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in FrameState.FIELDS}


def camera_frame_from_numpy(cam, device):
    """vkr_tpu's CameraFrame (view, prev_view, mvp, prev_mvp, jitter: arrays
    numpy can read, one camera or a batch stacked on a leading axis as
    vkr_tpu's batch_cams makes it) -> the port's frame.CameraFrame on
    `device`."""
    from vkr_tpu_torch.frame import CameraFrame

    return CameraFrame(*(
        torch.as_tensor(np.array(getattr(cam, name), np.float32),
                        device=device) for name in CameraFrame._fields))
