"""Pixel-band multi-device rendering over torch.distributed.

The port of vkr_tpu/parallel/band.py. Every rank of a process group renders
one horizontal band of the frame's rows:

  * G-buffer: the rank rasterises and resolves only its rows (the band
    viewport of raster/setup.py: edge and depth planes in full-frame
    coordinates, bbox and binning windowed to the band, the kernels adding
    the band's first row to their pixel rows), so the gathered G-buffer is
    bit for bit the one-device G-buffer.
  * The band G-buffer planes are all-gathered over rows and the bin-pair
    overflow summed.
  * The image-space chain runs in band mode (frame.shade_frame's band and
    gather_fn): every expensive pass computes the rank's rows from
    whole-frame inputs, and each output is all-gathered back. hi-Z and the
    histories stay whole on every rank.

Every rank returns the whole colour, FrameState and aux. vkr_tpu all-gathers
and so does the port: no halo exchange by point-to-point sends.

The gather is all_gather_single (all_gather_into_tensor in older torch)
over the leading row axis. The group's backend, which the caller chose,
decides its form (RowGather):
  * gloo, whose collectives take CPU tensors only: each band is staged
    through host memory and the whole tensor copied back to the rank's
    device. A CUDA graph cannot hold that, so each gather call is a host
    step (core/aot.py:host_step): a frame captured by cached_jit ends a
    graph segment before it and begins the next after it. The frame calls
    gathers that follow each other as one (the G-buffer's five planes and
    the overflow sum; SSR's rays and occlusion), so the default frame has
    9 host steps and 10 segments.
  * NCCL (one card per rank): the device tensors go to the collective
    directly, on the current stream, and a captured frame records the
    collectives into its one graph.
"""

from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from vkr_tpu_torch.core import aot, registry
from vkr_tpu_torch.core.graph import add_task

# torch 2.13 names the tensor all-gather all_gather_single and deprecates
# all_gather_into_tensor, the name older releases have
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class RowGather:
    """gather_fn of band mode: bands (band rows, ...) on `device` -> each
    whole (group size x band rows, ...), rank order, on `device`.

    stats: an optional dict; when given, each call synchronises the card
    before and after and adds its seconds to stats["gather_s"] and one to
    stats["gathers"] (the band's compute then stays out of the gather's
    time). An eager frame's only: a captured frame cannot synchronise
    inside its graph, so stats raises there; its host steps are timed by
    the CapturedFrame (step_seconds)."""

    def __init__(self, group, device, stats=None):
        self.group = group
        self.device = torch.device(device)
        self.n = dist.get_world_size(group)
        self.via_host = dist.get_backend(group) == "gloo"
        self.stats = stats

    def _sync(self):
        if self.stats is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *bands, total=None):
        """Each band made whole and, with `total`, that tensor summed over
        the group (an all_reduce), last; one band and no total give a
        tensor, else a tuple. Under gloo the call is one host step
        (core/aot.py:host_step); under NCCL its collectives run on
        the current stream, where a capture records them."""
        if self.stats is not None and aot.capturing():
            raise RuntimeError(
                "RowGather: stats synchronises the card around each gather,"
                " which a captured frame cannot do; read the CapturedFrame's"
                " step_seconds instead")
        aot.collective()
        xs = bands + (() if total is None else (total,))
        collect = functools.partial(self._collect, len(bands))
        self._sync()
        t0 = time.perf_counter()
        out = aot.host_step(collect, *xs) if self.via_host else collect(*xs)
        if self.stats is not None:
            self._sync()
            self.stats["gather_s"] = (self.stats.get("gather_s", 0.0)
                                      + time.perf_counter() - t0)
            self.stats["gathers"] = self.stats.get("gathers", 0) + 1
        return out[0] if len(out) == 1 else out

    def _collect(self, n_bands, *xs):
        """The first n_bands of xs all-gathered over rows, the rest summed;
        staged through host memory under gloo."""
        out = []
        for i, x in enumerate(xs):
            src = x.cpu() if self.via_host else x
            if i < n_bands:
                src = src.contiguous()
                whole = torch.empty((self.n * src.shape[0],)
                                    + tuple(src.shape[1:]),
                                    dtype=src.dtype, device=src.device)
                _ALL_GATHER(whole, src, group=self.group)
            else:
                whole = src.clone()
                dist.all_reduce(whole, op=dist.ReduceOp.SUM,
                                group=self.group)
            out.append(whole.to(self.device))
        return tuple(out)

    def sum(self, x):
        """x summed over the group (an all_reduce), on `device`."""
        return self(total=x)


def band_rows(height: int, group=None):
    """(row0, band_h) of the calling rank: the frame's rows in equal bands
    of an even height, one per rank, in rank order."""
    n = dist.get_world_size(group)
    if height % (2 * n):
        raise ValueError(f"height {height} does not split into {n} bands "
                         "of an even height")
    band_h = height // n
    return dist.get_rank(group) * band_h, band_h


def render_frame_banded(scene, state, cam, ssr_res, cfg, group=None, *,
                        device, probe_grid=None, tri_grid=None,
                        use_kernels: bool = True, tuning=None, stats=None):
    """One frame band-sharded over the ranks of `group` (None: the world),
    the calling rank's share computed on `device`, where scene, state, cam,
    ssr_res and the grids live. Every rank of the group must call it with
    the same arguments (vkr_tpu band.py:41-117).

    Returns (colour (H, W, 3), the new FrameState, aux), whole on every
    rank: the G-buffer and prev_depth bit for bit those of render_frame on
    one device, the colour and TAA history equal up to float32 rounding
    (tests/test_torch_parallel.py). cfg.height must split into
    group-size bands of an even height (the half-res chain and the
    G-buffer's 2x2 texture-LOD quads). stats: RowGather's."""
    from vkr_tpu_torch.frame import shade_frame
    from vkr_tpu_torch.passes.gbuffer import GBuffer

    h, w = cfg.height, cfg.width
    row0, band_h = band_rows(h, group)
    gather = RowGather(group, device, stats)
    gb = add_task(
        "GbufferPass",
        lambda: registry.get("gbuf_opaque_taa")(
            scene, cam.mvp, cam.prev_mvp, cam.jitter,
            width=w, height=band_h, quantize=cfg.quantize_formats,
            mask_peel_layers=cfg.raster.mask_peel_layers,
            trilinear=cfg.trilinear_textures, oracle=not use_kernels,
            full_height=h, row_offset=row0))
    planes = ("albedo", "normal", "material", "velocity", "depth")
    *whole, overflow = gather(*(getattr(gb, k) for k in planes),
                              total=gb.overflow)
    gbuf = GBuffer(**dict(zip(planes, whole)), overflow=overflow)
    return shade_frame(gbuf, state, cam, ssr_res, cfg, probe_grid=probe_grid,
                       tri_grid=tri_grid, use_kernels=use_kernels,
                       tuning=tuning, band=(row0, band_h), gather_fn=gather)
