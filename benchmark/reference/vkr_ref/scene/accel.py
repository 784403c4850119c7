"""Scene acceleration structure: the uniform-grid BLAS/TLAS analog.

The port of vkr_tpu/scene/accel.py. The reference builds per-mesh Vulkan
BLASes and a TLAS (src/scene/scene_as.cpp:19-134,205-272) and queries
them with hardware ray queries (gtao.cpp:150-196, shaders/gtao/
rt_main.frag). vkr_tpu, and so the port, uses a uniform grid over the
world-space triangles instead:

  * build (host, numpy float64, once at scene upload): every triangle is
    binned into the cells its bounding box overlaps, in a dense
    (cells, CAP) table of triangle ids (-1 = empty slot). A full cell keeps
    its first CAP ids, in triangle order; each (triangle, cell) pair that
    did not fit is counted in TriGrid.overflowed. A dropped pair can only
    turn a hit into a miss.
  * traversal: a 3-D DDA walks up to max_steps cells per ray and tests
    each cell's filled slots with Moller-Trumbore any-hit. ray_any_hit
    runs it on the card in csrc/ray_any_hit.cu (R1), one thread per ray,
    a launch of fixed shape that a captured frame (core/aot.py) records,
    over the grid's slot records (slot_records, made with the grid); on
    CPU tensors it takes the plain version, ray_any_hit_reference.

vkr_tpu computes the traversal in jnp inside a lax.fori_loop, and XLA
compiles its cross products and 3-term dot products into fmas. The port
rounds them the same way (cross, dot3), so the same rays give the same
hits, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vkr_ref import kernels
from vkr_ref.mathlib.brdf import _fma

CUDA = torch.device("cuda")
# Rays per traversal batch: bounds the (rays, CAP, 9) slot gather of one
# DDA step to about 0.9 GB at CAP 24.
RAY_CHUNK = 1 << 20


@dataclasses.dataclass
class TriGrid:
    """Uniform-grid acceleration structure (the BLAS/TLAS analog).

    records and spans, R1's slot table (slot_records), are made from
    tri_verts and cell_tris whenever a TriGrid is made of those two
    tensors; a value passed in for them is replaced, so a grid made with
    other tables (dataclasses.replace) has its own. They are fields, so a
    captured frame (core/aot.py) takes them as leaves of its arguments
    and copies them in together with the tables they come from. A TriGrid
    whose tables are not tensors (aot's _flat rebuilds the structure with
    None leaves) has None for both."""

    tri_verts: torch.Tensor   # (T, 3, 3) f32 world-space triangles
    cell_tris: torch.Tensor   # (cells, CAP) i32 triangle ids, -1 empty
    grid_min: torch.Tensor    # (3,) f32
    cell_size: torch.Tensor   # (3,) f32
    dims: Tuple[int, int, int]  # cell counts per axis
    cap: int                    # slots per cell
    overflowed: int             # (triangle, cell) pairs that did not fit
    records: "torch.Tensor | None" = None  # (cells * CAP, 12) f32
    spans: "torch.Tensor | None" = None    # (cells, 2) i32

    def __post_init__(self):
        self.records = self.spans = None
        if (isinstance(self.tri_verts, torch.Tensor)
                and isinstance(self.cell_tris, torch.Tensor)):
            self.records, self.spans = slot_records(self.tri_verts,
                                                    self.cell_tris)


def slot_records(tri_verts, cell_tris):
    """R1's slot table, on the tables' device, with no read to the host.

    records: (cells * CAP, 12) float32. For every filled slot (id >= 0),
    in cell order and then slot order, the row v0, e1 = v1 - v0,
    e2 = v2 - v0, each padded with a 0 to four floats (csrc/ray_any_hit.cu
    loads them as three float4). e1 and e2 are the float32 subtractions
    the slot test forms, so a test on the row gives the same bits. The
    rows after the last filled slot are 0. spans: (cells, 2) int32, each
    cell's first row and its number of filled slots; the rows of cell k
    are spans[k, 0] .. spans[k, 0] + spans[k, 1] - 1. Empty slots anywhere
    in a cell are skipped, not assumed to come last."""
    n_cells, cap = cell_tris.shape
    filled = cell_tris >= 0
    count = filled.sum(1)
    start = torch.cumsum(count, 0) - count
    # a filled slot's row: its cell's start plus the filled slots before
    # it; every empty slot goes to one spare row, dropped after
    rank = torch.cumsum(filled.int(), 1) - 1
    row = torch.where(filled, start[:, None] + rank, n_cells * cap)
    tv = tri_verts[cell_tris.clamp(min=0).reshape(-1)]
    zero = torch.zeros_like(tv[:, 0, :1])
    vals = torch.cat([tv[:, 0], zero, tv[:, 1] - tv[:, 0], zero,
                      tv[:, 2] - tv[:, 0], zero], -1)
    records = torch.zeros(n_cells * cap + 1, 12, dtype=vals.dtype,
                          device=vals.device)
    records[row.reshape(-1)] = vals
    spans = torch.stack([start, count], -1).to(torch.int32)
    return records[:-1], spans.contiguous()


def build_tri_grid(world_positions, indices, resolution: int = 48,
                   cap: int = 24, device=CUDA) -> TriGrid:
    """Bin world-space triangles into a uniform grid on the host, the
    tables then go to `device` (the card unless the caller asks for
    another).

    world_positions: (V, 3); indices: (T, 3) int. resolution: cells on the
    longest axis (the others scale by extent, at least 1). cap: slots per
    cell. The binning equals vkr_tpu's triple loop slot for slot: a
    triangle's cells are visited z, y, x (x fastest), triangles in order,
    so a cell's slots hold its first cap triangles by id."""
    pos = np.asarray(world_positions, np.float64)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    tri = pos[idx]  # (T, 3, 3)
    t_min = tri.min(axis=1)
    t_max = tri.max(axis=1)
    lo = t_min.min(axis=0)
    hi = t_max.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    longest = extent.max()
    dims = np.maximum(
        1, np.round(extent / longest * resolution).astype(np.int64))
    cell = extent / dims
    ncell = int(dims.prod())
    sx, sy, sz = int(dims[0]), int(dims[1]), int(dims[2])

    c_lo = np.clip(((t_min - lo) / cell).astype(np.int64), 0, dims - 1)
    c_hi = np.clip(((t_max - lo) / cell).astype(np.int64), 0, dims - 1)
    span = c_hi - c_lo + 1  # (T, 3)

    # every (triangle, cell) pair in the loop's order
    n_pairs = span.prod(axis=1)
    tri_of = np.repeat(np.arange(len(tri)), n_pairs)
    k = np.arange(tri_of.size) - np.repeat(np.cumsum(n_pairs) - n_pairs,
                                           n_pairs)
    nx, ny = span[tri_of, 0], span[tri_of, 1]
    base = c_lo[tri_of]
    cell_of = (((base[:, 2] + k // (nx * ny)) * sy
                + base[:, 1] + (k // nx) % ny) * sx + base[:, 0] + k % nx)
    # a cell's slot of a pair = the pairs of that cell before it
    order = np.argsort(cell_of, kind="stable")
    cells = cell_of[order]
    rank = np.arange(cells.size) - np.searchsorted(cells, cells, "left")
    keep = rank < cap
    table = np.full((ncell, cap), -1, np.int64)
    table[cells[keep], rank[keep]] = tri_of[order][keep]
    return TriGrid(
        tri_verts=torch.as_tensor(tri.astype(np.float32), device=device),
        cell_tris=torch.as_tensor(table.astype(np.int32), device=device),
        grid_min=torch.as_tensor(lo.astype(np.float32), device=device),
        cell_size=torch.as_tensor(cell.astype(np.float32), device=device),
        dims=(sx, sy, sz),
        cap=int(cap),
        overflowed=int((~keep).sum()),
    )


def cross(a, b):
    """jnp.cross as XLA compiles it: component i is
    fma(a_j, b_k, -(a_k * b_j))."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], -1)


def dot3(a, b):
    """(a * b).sum(-1) over 3 components as XLA compiles it inside a loop:
    an fma chain from the first product."""
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _tri_hit_mask(orig, dirs, v0, e1, e2, t_max, eps=1e-12):
    """Moller-Trumbore any-hit for t in (eps, t_max). All args broadcast
    over leading dims; returns a bool mask."""
    p = cross(dirs, e2)
    det = dot3(e1, p)
    inv = torch.where(det.abs() < 1e-20, 0.0,
                      1.0 / torch.where(det == 0.0, 1.0, det))
    s = orig - v0
    u = dot3(s, p) * inv
    q = cross(s, e1)
    v = dot3(dirs, q) * inv
    t = dot3(e2, q) * inv
    return ((det.abs() >= 1e-20) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > eps) & (t < t_max))


def ray_any_hit(grid: TriGrid, origin, direction, t_max,
                max_steps: "int | None" = None, ray_chunk: int = RAY_CHUNK):
    """R1, the rayQuery any-hit analog: True where the segment
    origin + t * direction, t in (0, t_max], hits scene geometry.

    origin/direction: (..., 3) float32; t_max: a float, or a float32
    tensor that broadcasts to the leading shape (0-d: one value for all
    rays); max_steps: cells per ray (default: the whole grid). Returns a
    bool tensor of the leading shape. On CUDA tensors csrc/ray_any_hit.cu
    computes it, one thread per ray over the grid's slot records, with
    the plain version's hits (scene/accel.py:ray_any_hit_reference; the
    kernel's fmaf rounds once where the plain version's float64 _fma
    rounds twice); dims, max_steps and t_max go in as kernel arguments,
    and nothing is read from the host. On CPU tensors the plain version,
    in batches of ray_chunk rays (the kernel has no batches)."""
    if True:  # frozen copy: the plain version on every device
        return ray_any_hit_reference(grid, origin, direction, t_max,
                                     max_steps=max_steps, ray_chunk=ray_chunk)
    lead = origin.shape[:-1]
    o = origin.reshape(-1, 3).contiguous()
    d = direction.reshape(-1, 3).contiguous()
    _check_kernel_inputs(grid, o, d, t_max, direction.shape == origin.shape,
                         lead)
    n = o.shape[0]
    sx, sy, sz = grid.dims
    steps = sum(grid.dims) if max_steps is None else int(max_steps)
    value, per_ray, stride = _kernel_t_max(t_max, lead)
    hit = torch.empty(n, dtype=torch.bool, device=o.device)
    err = kernels.library("ray_any_hit").vkr_ray_any_hit(
        o.data_ptr(), d.data_ptr(), value,
        None if per_ray is None else per_ray.data_ptr(), stride, n,
        grid.records.data_ptr(), grid.spans.data_ptr(),
        grid.grid_min.data_ptr(), grid.cell_size.data_ptr(), sx, sy, sz,
        steps, hit.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    kernels.check(err, "ray_any_hit")
    kernels.LAUNCHES["ray_any_hit"] += 1
    return hit.reshape(lead)


def _kernel_t_max(t_max, lead):
    """t_max as the kernel takes it: (the number, the tensor it reads or
    None, that tensor's stride per ray). A float goes in by value, a 0-d
    tensor with stride 0, any other tensor broadcast to the leading shape
    with stride 1."""
    if not isinstance(t_max, torch.Tensor):
        return float(t_max), None, 0
    if t_max.dim() == 0:
        return 0.0, t_max, 0
    return 0.0, t_max.expand(lead).reshape(-1).contiguous(), 1


def _check_kernel_inputs(grid, o, d, t_max, same_shape, lead=None):
    """Raise on what csrc/ray_any_hit.cu does not take: float32 rays,
    vertex tables and slot records and int32 cells and spans, contiguous,
    on one CUDA device; t_max a number or a float32 tensor there that
    broadcasts to the leading shape `lead` (default: o's); fewer than 2^31
    rays."""
    lead = o.shape[:-1] if lead is None else tuple(lead)
    floats = (o, d, grid.tri_verts, grid.grid_min, grid.cell_size,
              grid.records)
    for t in floats + (grid.cell_tris, grid.spans):
        want = (torch.int32 if t is grid.cell_tris or t is grid.spans
                else torch.float32)
        if t.device != o.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"ray_any_hit: every input must be contiguous "
                             f"on {o.device} (cell_tris and spans int32, "
                             f"the rest float32), got {t.dtype} on "
                             f"{t.device}")
    if isinstance(t_max, torch.Tensor):
        try:
            fits = torch.broadcast_shapes(t_max.shape, lead) == lead
        except RuntimeError:
            fits = False
        if (t_max.dtype != torch.float32 or t_max.device != o.device
                or not fits):
            raise ValueError(f"ray_any_hit: a t_max tensor must be float32 "
                             f"on {o.device} and broadcast to the rays' "
                             f"leading shape {tuple(lead)}, got "
                             f"{t_max.dtype} {tuple(t_max.shape)} on "
                             f"{t_max.device}")
    if not same_shape or o.shape[0] >= 2 ** 31:
        raise ValueError("ray_any_hit: origin and direction of one shape, "
                         "fewer than 2^31 rays")
    if not o.is_cuda:
        raise ValueError(f"ray_any_hit: unsupported device {o.device}")


def ray_any_hit_reference(grid: TriGrid, origin, direction, t_max,
                          max_steps: "int | None" = None,
                          ray_chunk: int = RAY_CHUNK):
    """ray_any_hit's plain version: True where the segment
    origin + t * direction, t in (0, t_max], hits scene geometry.

    origin/direction: (..., 3); t_max: a float or (...). A 3-D DDA walks
    at most max_steps cells per ray (default: the whole grid) and tests
    each cell's CAP slots. Rays go through in batches of ray_chunk, and a
    ray leaves its batch's work once it has hit or left the grid or its
    segment: vkr_tpu walks it on, but nothing it does after that reaches
    the result."""
    lead = origin.shape[:-1]
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tm = tm.expand(lead).reshape(-1)
    if max_steps is None:
        max_steps = sum(grid.dims)
    tv = grid.tri_verts
    # (T, 9): v0, e1 = v1 - v0, e2 = v2 - v0, as the slot test forms them
    tri9 = torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]],
                     -1)
    hit = torch.cat([
        _any_hit_batch(grid, tri9, o[i:i + ray_chunk], d[i:i + ray_chunk],
                       tm[i:i + ray_chunk], max_steps)
        for i in range(0, o.shape[0], ray_chunk)])
    return hit.reshape(lead)


def _any_hit_batch(grid, tri9, o, d, tm, max_steps):
    dev = o.device
    sx, sy, sz = grid.dims
    dims = torch.tensor([sx, sy, sz], device=dev)
    cell = grid.cell_size
    gmin = grid.grid_min
    flat_dim = sx * sy * sz

    small = d.abs() < 1e-20
    inv = torch.where(small, 1e20, 1.0 / torch.where(d == 0.0, 1.0, d))
    # entry cell; XLA's float-to-int cast saturates, PyTorch's does not
    rel = (o - gmin) / cell
    ic = torch.minimum(torch.floor(rel).clamp(-1.0, 2.0 ** 24).long()
                       .clamp(min=0), dims - 1)
    step = torch.where(d >= 0.0, 1, -1)
    next_b = (ic + (step > 0).long()).float()
    t_next = (next_b * cell + gmin - o) * inv
    t_next = torch.where(small, 1e20, t_next)
    dt = (cell * inv).abs()

    hit = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    ids = torch.arange(o.shape[0], device=dev)
    axes = torch.arange(3, device=dev)
    for _ in range(max_steps):
        if ids.numel() == 0:
            break
        flat = ((ic[:, 2] * sy + ic[:, 1]) * sx + ic[:, 0]).clamp(
            0, flat_dim - 1)
        slots = grid.cell_tris[flat]                      # (n, CAP)
        t9 = tri9[slots.clamp(min=0)]                     # (n, CAP, 9)
        m = _tri_hit_mask(o[:, None], d[:, None], t9[..., 0:3], t9[..., 3:6],
                          t9[..., 6:9], tm[:, None])
        m = (m & (slots >= 0)).any(-1)
        hit[ids] = m
        # advance to the next cell along the smallest t_next (ties: the
        # first axis, as jnp.argmin)
        tmin = t_next.amin(-1)
        onehot = torch.argmin(t_next, -1)[:, None] == axes
        ic_new = ic + torch.where(onehot, step, 0)
        t_next = t_next + torch.where(onehot, dt, 0.0)
        inside = ((ic_new >= 0) & (ic_new < dims)).all(-1)
        sel = torch.nonzero(inside & (tmin <= tm) & ~m).squeeze(1)
        ids, ic, t_next = ids[sel], ic_new[sel], t_next[sel]
        o, d, tm, step, dt = o[sel], d[sel], tm[sel], step[sel], dt[sel]
    return hit
