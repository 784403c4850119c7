"""View-parallel multi-device rendering over torch.distributed.

The port of vkr_tpu/parallel/sharding.py: a batch of V cameras (probe
cubemap faces, stereo eyes, jitter phases) rendered one per rank with the
scene replicated, the probe renderer's embarrassingly view-parallel shape
(probe_renderer.cpp renders 6 faces x grid^2 probes). vkr_tpu's mesh is a
jax Mesh; the port's is a RenderMesh, the process group of the ranks and
the calling rank's device. The process group itself is the caller's
(torch.distributed.init_process_group): nothing here starts processes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from vkr_tpu_torch.parallel.band import RowGather


class RenderMesh(NamedTuple):
    """The calling rank's handle on the ranks that render together."""

    group: object            # torch.distributed group; None = the world
    device: torch.device     # the calling rank's device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def make_render_mesh(n_devices: Optional[int] = None, *,
                     device=None) -> RenderMesh:
    """The mesh of the first n_devices ranks of the initialised default
    group (all of them when None), as vkr_tpu's make_render_mesh takes the
    first n devices. Every rank must call it (a sub-group is made
    collectively). device: the calling rank's device, by default its card,
    cuda:(rank mod the visible cards), which raises without one; pass a
    CPU device to render on the CPU."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_render_mesh: {n} devices of a world of "
                         f"{world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_render_mesh: no CUDA card is available;"
                               " pass device='cpu' to render on the CPU")
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    return RenderMesh(group=group, device=torch.device(device))


def render_views_sharded(scene, states, cams, ssr_res, cfg,
                         mesh: RenderMesh, *, use_kernels: bool = True):
    """Render V views, view v on rank v of `mesh` (V == mesh size), the
    scene and LUTs replicated on every rank's device.

    states: a FrameState batched on axis 0 (batch_states); cams: a
    CameraFrame batched on axis 0 (batch_cams). Returns (colours (V, H, W,
    3), the new states batched), whole on every rank (vkr_tpu
    sharding.py:41-81 returns them sharded over the view axis). The
    gather is one call: one host step of a frame captured under gloo, so
    the captured views are two segments (core/aot.py)."""
    from vkr_tpu_torch.frame import CameraFrame, render_frame

    n, v = mesh.size, mesh.rank
    if cams.mvp.shape[0] != n:
        raise ValueError(f"render_views_sharded: {cams.mvp.shape[0]} views "
                         f"on a mesh of {n}")
    state = unbatch_state(states, v)
    cam = CameraFrame(*(t[v] for t in cams))
    color, new_state, _ = render_frame(scene, state, cam, ssr_res, cfg,
                                       use_kernels=use_kernels)
    names = [name for name in new_state.FIELDS if name != "frame_index"]
    colors, *fields = RowGather(mesh.group, mesh.device)(
        color[None], *(getattr(new_state, name)[None] for name in names))
    new_states = new_state.replace(frame_index=states.frame_index + 1,
                                   **dict(zip(names, fields)))
    return colors, new_states


def batch_states(make_state, n: int):
    """n fresh FrameStates stacked on a new leading axis (frame_index
    (n,) int32, as vkr_tpu's batch axis gives it)."""
    states = [make_state() for _ in range(n)]
    return states[0].replace(
        **{name: torch.stack([getattr(s, name) for s in states])
           for name in states[0].FIELDS})


def unbatch_state(states, v: int):
    """View v of a batched FrameState."""
    return states.replace(**{name: getattr(states, name)[v]
                             for name in states.FIELDS})


def batch_cams(cams):
    """CameraFrames -> one CameraFrame, each matrix stacked on a new leading
    axis."""
    from vkr_tpu_torch.frame import CameraFrame

    return CameraFrame(*(torch.stack(ts) for ts in zip(*cams)))
