"""vkr_tpu_torch/scene/accel.py against vkr_tpu/scene/accel.py: the
uniform-grid build (slot for slot, overflow included) and the any-hit
traversal, on numpy-seeded triangles and rays given to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu.scene import accel as jaccel
from vkr_tpu_torch.scene import accel as taccel

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


def _random_triangles(seed=3, n_tri=60):
    """test_accel.py's clustered random triangles in the unit cube."""
    rng = np.random.default_rng(seed)
    tri = (rng.uniform(0, 1, (n_tri, 1, 3))
           + rng.uniform(-0.12, 0.12, (n_tri, 3, 3)))
    return tri.reshape(-1, 3), np.arange(n_tri * 3).reshape(-1, 3)


def _colonnade_triangles():
    """World-space triangles of the 24-column hall at tessellation 4, by
    vkr_tpu's build_scene_tri_grid rule."""
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    sc = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    m = sc.transforms[sc.vert_transform]
    world = np.einsum("vij,vj->vi", m[:, :3, :3], sc.positions) + m[:, :3, 3]
    return world, sc.tri_indices


def _rays(seed, n, lo, hi, t_lo, t_hi):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # a few axis-aligned directions take the 1e20 path
    d[: n // 64, 1:] = 0.0
    d[: n // 64, 0] = 1.0
    t_max = rng.uniform(t_lo, t_hi, n).astype(np.float32)
    return orig, d, t_max


def _grids(case):
    verts, idx, res, cap = {
        "random": _random_triangles() + (10, 48),
        "random_overflow": _random_triangles() + (10, 2),
        "colonnade": _colonnade_triangles() + (16, 8),
    }[case]
    return (jaccel.build_tri_grid(verts, idx, resolution=res, cap=cap),
            taccel.build_tri_grid(verts, idx, resolution=res, cap=cap,
                                  device="cpu"))


@pytest.mark.parametrize("case", ["random", "random_overflow", "colonnade"])
def test_build_equals_vkr_tpu(case):
    """The vectorised build gives vkr_tpu's table slot for slot. On the
    colonnade at resolution 16 and cap 8 (16x1x2 cells) 1,284 (triangle,
    cell) pairs overflow; with cap 2 the random triangles overflow too."""
    jg, tg = _grids(case)
    np.testing.assert_array_equal(tg.cell_tris.numpy(),
                                  np.asarray(jg.cell_tris))
    np.testing.assert_array_equal(tg.tri_verts.numpy(),
                                  np.asarray(jg.tri_verts))
    np.testing.assert_array_equal(tg.grid_min.numpy(),
                                  np.asarray(jg.grid_min))
    np.testing.assert_array_equal(tg.cell_size.numpy(),
                                  np.asarray(jg.cell_size))
    assert tg.dims == jg.dims and tg.cap == jg.cap
    assert tg.overflowed == jg.overflowed
    assert (tg.overflowed > 0) == (case != "random")
    if case == "colonnade":
        assert tg.overflowed == 1284 and tg.dims == (16, 1, 2)


@pytest.mark.parametrize("case", ["random", "colonnade"])
def test_any_hit_bit_equal_to_vkr_tpu(case):
    """4,096 seeded rays: the port's hits equal vkr_tpu's on every ray
    (share 1.0; measured 1.0 on both inputs). vkr_tpu's loop body is
    compiled, so its cross and dot products are fmas; the port's cross and
    dot3 round the same way (with plain products about a third of the
    determinants differ in the last bit)."""
    jg, tg = _grids(case)
    if case == "random":
        orig, d, t_max = _rays(11, 4096, 0.05, 0.95, 0.05, 0.6)
    else:
        lo, hi = np.asarray(jg.grid_min), np.asarray(jg.grid_min) + \
            np.asarray(jg.cell_size) * np.asarray(jg.dims)
        orig, d, t_max = _rays(12, 4096, lo, hi, 0.1, 3.0)
    want = np.asarray(jaccel.ray_any_hit(jg, jnp.asarray(orig),
                                         jnp.asarray(d), jnp.asarray(t_max)))
    got = taccel.ray_any_hit(tg, torch.from_numpy(orig), torch.from_numpy(d),
                             torch.from_numpy(t_max)).numpy()
    share = float((got == want).mean())
    print(f"{case}: hit share {want.mean():.4f}, bit-equal {share}")
    assert 0.02 < want.mean() < 0.98
    assert share == 1.0


def test_any_hit_matches_bruteforce():
    """With a cap that drops nothing, the grid walk finds exactly the rays
    that hit some triangle (every triangle tested, the port's own
    Moller-Trumbore)."""
    jg, tg = _grids("random")
    assert tg.overflowed == 0
    orig, d, t_max = _rays(13, 512, 0.05, 0.95, 0.05, 0.6)
    o, dd, tm = map(torch.from_numpy, (orig, d, t_max))
    tv = tg.tri_verts
    brute = taccel._tri_hit_mask(
        o[:, None], dd[:, None], tv[None, :, 0], (tv[:, 1] - tv[:, 0])[None],
        (tv[:, 2] - tv[:, 0])[None], tm[:, None]).any(-1)
    got = taccel.ray_any_hit(tg, o, dd, tm)
    assert brute.any() and not brute.all()
    assert torch.equal(got, brute)


def test_chunking_changes_nothing():
    """Batches of 1, 7 and 1,000 rays give the hits of one batch of all,
    and a max_steps sized to the segment gives the whole walk's."""
    _, tg = _grids("colonnade")
    lo = tg.grid_min.numpy()
    hi = lo + tg.cell_size.numpy() * np.asarray(tg.dims)
    orig, d, t_max = _rays(14, 3000, lo, hi, 0.1, 3.0)
    o, dd = torch.from_numpy(orig), torch.from_numpy(d)
    whole = taccel.ray_any_hit(tg, o, dd, torch.from_numpy(t_max))
    for chunk in (1000, 7):
        assert torch.equal(whole, taccel.ray_any_hit(
            tg, o, dd, torch.from_numpy(t_max), ray_chunk=chunk))
    assert torch.equal(whole[:50], taccel.ray_any_hit(
        tg, o[:50], dd[:50], torch.from_numpy(t_max[:50]), ray_chunk=1))
    # 3 world units cross at most ceil(3 / cell) cells per axis
    steps = int(np.ceil(3.0 / tg.cell_size.min().item())) * 3 + 2
    assert torch.equal(whole, taccel.ray_any_hit(
        tg, o, dd, torch.from_numpy(t_max), max_steps=steps))
    # rays of shape (..., 3) keep their leading shape
    assert torch.equal(whole.reshape(30, 100), taccel.ray_any_hit(
        tg, o.reshape(30, 100, 3), dd.reshape(30, 100, 3),
        torch.from_numpy(t_max).reshape(30, 100)))


# the edge paths of the walk that the kernel (csrc/ray_any_hit.cu) copies
EDGE_CASES = ("axis_aligned", "outside", "boundaries", "non_finite",
              "short")


def _edge_rays(case, grid, n=2048, seed=21):
    """Rays that take one edge path of the walk, inside and around the
    random triangles' grid: axis-aligned directions whose other
    components are +0.0, -0.0 or below the 1e-20 guard; origins up to a
    cell outside the grid; origins on cell boundaries (one, two or three
    axes); NaN and +-inf origins, as far-plane pixels give them; and
    t_max below one cell."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lo = grid.grid_min.numpy()
    cell = grid.cell_size.numpy()
    dims = np.asarray(grid.dims)
    hi = lo + cell * dims
    o = rng.uniform(lo, hi, (n, 3)).astype(f32)
    d = rng.normal(size=(n, 3)).astype(f32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 3.0, n).astype(f32) * f32(cell.max())
    if case == "axis_aligned":
        axis = rng.integers(0, 3, n)
        other = rng.choice([0.0, -0.0, 1e-25, -1e-25, 1e-19],
                           size=(n, 3)).astype(f32)
        d = np.where(np.arange(3) == axis[:, None],
                     rng.choice([-1.0, 1.0], n)[:, None], other).astype(f32)
    elif case == "outside":
        o = rng.uniform(lo - cell, hi + cell, (n, 3)).astype(f32)
    elif case == "boundaries":
        k = rng.integers(0, dims + 1, (n, 3)).astype(f32)
        on = rng.random((n, 3)) < np.array([0.4, 0.6, 0.8])[
            rng.integers(0, 3, n)][:, None]
        o = np.where(on, lo.astype(f32) + k * cell.astype(f32), o)
    elif case == "non_finite":
        bad = rng.choice([np.nan, np.inf, -np.inf], n).astype(f32)
        axis = rng.integers(0, 4, n)  # 3: every component
        o = np.where((np.arange(3) == axis[:, None]) | (axis[:, None] == 3),
                     bad[:, None], o).astype(f32)
    elif case == "short":
        t_max = (rng.uniform(0.0, 1.0, n) * cell.min()).astype(f32)
    return o.astype(f32), d.astype(f32), t_max.astype(f32)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_reference_edge_rays_bit_equal_to_vkr_tpu(case):
    """ray_any_hit_reference, the spec the kernel copies, against vkr_tpu's
    ray_any_hit on each edge path (_edge_rays), bit for bit."""
    jg, tg = _grids("random")
    orig, d, t_max = _edge_rays(case, tg)
    want = np.asarray(jaccel.ray_any_hit(jg, jnp.asarray(orig),
                                         jnp.asarray(d), jnp.asarray(t_max)))
    got = taccel.ray_any_hit_reference(
        tg, torch.from_numpy(orig), torch.from_numpy(d),
        torch.from_numpy(t_max)).numpy()
    print(f"{case}: hit share {want.mean():.4f}")
    np.testing.assert_array_equal(got, want)
    if case == "non_finite":
        assert not want.any()
    else:
        assert 0.0 < want.mean() < 1.0


def test_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors ray_any_hit is ray_any_hit_reference: the same hits,
    no CUDA library asked for, kernels.LAUNCHES untouched. The kernel
    path's checks take a t_max tensor of the leading shape and a 0-d one
    (vkr_tpu's ray_any_hit broadcasts t_max), and refuse a t_max tensor
    that is not float32 or does not broadcast, a CPU tensor and a float64
    ray."""
    from vkr_tpu_torch import kernels

    def no_library(name):
        raise AssertionError(f"a CPU call asked for the {name} library")

    monkeypatch.setattr(kernels, "library", no_library)
    _, tg = _grids("colonnade")
    lo = tg.grid_min.numpy()
    hi = lo + tg.cell_size.numpy() * np.asarray(tg.dims)
    orig, d, t_max = _rays(15, 1000, lo, hi, 0.1, 3.0)
    o, dd = torch.from_numpy(orig), torch.from_numpy(d)
    before = dict(kernels.LAUNCHES)
    for tm in (torch.from_numpy(t_max), 1.5):
        got = taccel.ray_any_hit(tg, o.reshape(10, 100, 3),
                                 dd.reshape(10, 100, 3),
                                 tm if isinstance(tm, float)
                                 else tm.reshape(10, 100), max_steps=9)
        want = taccel.ray_any_hit_reference(
            tg, o, dd, tm if isinstance(tm, float) else tm, max_steps=9)
        assert got.dtype == torch.bool and got.shape == (10, 100)
        assert torch.equal(got.reshape(-1), want) and want.any()
    assert dict(kernels.LAUNCHES) == before
    # what the kernel does not take raises before any launch; a t_max
    # tensor that it takes gets as far as the device check
    lead = (10, 100)
    o3, d3 = o.reshape(*lead, 3), dd.reshape(*lead, 3)
    for tm in (torch.from_numpy(t_max).reshape(lead), torch.tensor(1.5),
               torch.full((10, 1), 1.5)):
        with pytest.raises(ValueError, match="unsupported device cpu"):
            taccel._check_kernel_inputs(tg, o, dd, tm, True, lead)
        value, per_ray, stride = taccel._kernel_t_max(tm, lead)
        assert stride == (0 if tm.dim() == 0 else 1) and value == 0.0
        assert per_ray.is_contiguous() and per_ray.numel() in (1, 1000)
        assert torch.equal(per_ray.expand(1000) if stride == 0 else per_ray,
                           tm.expand(lead).reshape(-1))
        got = taccel.ray_any_hit(tg, o3, d3, tm, max_steps=9)
        assert torch.equal(got, taccel.ray_any_hit_reference(
            tg, o3, d3, tm, max_steps=9))
    assert taccel._kernel_t_max(1.5, lead) == (1.5, None, 0)
    for tm in (torch.from_numpy(t_max).double().reshape(lead),
               torch.ones(100, 10)):
        with pytest.raises(ValueError, match="t_max tensor must be float32"):
            taccel._check_kernel_inputs(tg, o, dd, tm, True, lead)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        taccel._check_kernel_inputs(tg, o, dd, 1.5, True)
    with pytest.raises(ValueError, match="contiguous"):
        taccel._check_kernel_inputs(tg, o.double(), dd, 1.5, True)


def _round_to_f32(x):
    """The exact rational x rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


def test_exact_fma_rounds_once():
    """chip_smoke.fma_exact, which the card check uses to show that a ray
    whose hit differs between R1 and its plain version is a
    double-rounding case of _fma, rounds a * b + c once: equal to the
    exact sum rounded to float32 on seeded operands and on the crafted
    case where _fma's float64 sum falls on a float32 tie
    (2^-25 (1 + 2^-10) (1 - 2^-10 + 2^-20) + 1 = 1 + 2^-25 + 2^-55:
    fmaf gives 1 + 2^-24, _fma 1)."""
    from fractions import Fraction

    import chip_smoke
    from vkr_tpu_torch.mathlib.brdf import _fma

    rng = np.random.default_rng(5)
    n = 2000
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=n) * 1e-6)
         ).astype(np.float32)
    c[::3] = rng.normal(size=c[::3].size).astype(np.float32)
    tie = np.float32(2.0 ** -25 * (1 + 2.0 ** -10)), np.float32(
        1 - 2.0 ** -10 + 2.0 ** -20), np.float32(1.0)
    a, b, c = (np.append(v, t) for v, t in zip((a, b, c), tie))
    got = chip_smoke.fma_exact(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([_round_to_f32(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[-1] == np.float32(1 + 2.0 ** -24)
    assert _fma(*(torch.from_numpy(v[-1:]) for v in (a, b, c))).item() == 1.0


def test_card_check_helpers_on_cpu():
    """chip_smoke's R1 helpers on CPU tensors: rt_slot_tests counts the
    filled slots the walk tests (at most the plain walk's slot tests, and
    with max_steps=1 exactly the entry cells' filled slots up to the first
    hit); rt_compare passes equal hits and fails a flipped one, which no
    rounding explains."""
    import chip_smoke

    _, tg = _grids("random")
    orig, d, t_max = _rays(16, 500, 0.05, 0.95, 0.05, 0.6)
    o, dd, tm = map(torch.from_numpy, (orig, d, t_max))
    n = chip_smoke.rt_slot_tests(tg, o, dd, tm, 1)
    # the entry cell of each ray, as the walk computes it
    rel = (o - tg.grid_min) / tg.cell_size
    ic = torch.minimum(torch.floor(rel).clamp(-1.0, 2.0 ** 24).long()
                       .clamp(min=0), torch.tensor(tg.dims) - 1)
    sx, sy, _ = tg.dims
    slots = tg.cell_tris[(ic[:, 2] * sy + ic[:, 1]) * sx + ic[:, 0]]
    v = tg.tri_verts[slots.clamp(min=0)]
    m = taccel._tri_hit_mask(o[:, None], dd[:, None], v[..., 0, :],
                             v[..., 1, :] - v[..., 0, :],
                             v[..., 2, :] - v[..., 0, :], tm[:, None])
    m &= slots >= 0
    first = torch.where(m.any(-1), m.int().argmax(-1) + 1, tg.cap)
    want = ((torch.arange(tg.cap) < first[:, None]) & (slots >= 0)).sum()
    assert n == int(want) > 0
    assert chip_smoke.rt_slot_tests(tg, o, dd, tm, None) >= n

    hits = taccel.ray_any_hit_reference(tg, o, dd, 0.4)
    err, ok, note = chip_smoke.rt_compare(hits, hits, (tg, o, dd, 0.4), {})
    assert (err, ok) == (0.0, True) and "500 rays" in note
    flipped = hits.clone()
    flipped[7] = ~flipped[7]
    err, ok, note = chip_smoke.rt_compare(flipped, hits, (tg, o, dd, 0.4),
                                          {})
    assert (err, ok) == (1.0, False) and "indices [7]" in note
