"""The schedule of the port's any-hit kernel (R1, csrc/ray_any_hit.cu),
transcribed to PyTorch and held against the plain version on the CPU. The
kernel itself builds and runs only on the card (chip_smoke.py); these
tests check the design contracts it rests on:

- the slot records (scene/accel.py:slot_records): each cell's rows are
  tri9 = (v0, v1 - v0, v2 - v0) of its filled slots in slot order, bit for
  bit, and the cells' (first row, count) cover every filled slot once,
  with empty slots anywhere in a cell;
- the kernel takes rays in order (thread i on ray i); the other thread ->
  ray maps that chip_smoke.py measures its SIMT efficiency against (one
  direction of 32 pixels of a row, of 8x4 pixels, of 8x4 pixels of one
  dither class) are permutations of the rays;
- each early exit of the slot test, the one before the division
  (chip_smoke.a_rejects) included, settles only misses;
- the walk over the records with the slot test's early exits
  (chip_smoke.rt_walk) gives ray_any_hit_reference's hits bit for bit, on
  the walk's edge rays (NaN and +-inf origins, +-0.0 direction
  components, per-ray t_max) and on seeded rays, and tests the slots that
  chip_smoke.rt_slot_tests counts;
- the operations bound charges each test up to where it ends, and the
  parent kernel's build (chip_smoke.build_r1_parent) takes only the C
  interfaces it knows.

Inputs come from numpy with fixed seeds, at small sizes."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_accel import EDGE_CASES, _edge_rays, _grids, _rays
from vkr_tpu_torch.scene import accel

torch.set_num_threads(1)


def _tri9(grid):
    tv = grid.tri_verts
    return torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]],
                     -1)


def _holed(grid, seed=4):
    """The grid with a third of its filled slots emptied (-1) by hand,
    before, between and after the filled ones."""
    rng = np.random.default_rng(seed)
    cells = grid.cell_tris.clone()
    cells[torch.from_numpy(rng.random(tuple(cells.shape)) < 0.33)] = -1
    return dataclasses.replace(grid, cell_tris=cells)


@pytest.fixture(scope="module")
def hall_grid():
    """The 1080p colonnade's scene grid at vkr_tpu's defaults (48, cap 24:
    dims (48, 2, 5), 7,126 filled slots)."""
    from vkr_tpu_torch.frame import build_scene_tri_grid
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    return build_scene_tri_grid(colonnade_scene(columns=24, tessellation=80,
                                                tex_size=16), device="cpu")


@pytest.mark.parametrize("case", ["hall", "hall_holed", "random_holed",
                                  "colonnade_overflow"])
def test_slot_records_are_tri9_of_the_filled_slots(case, hall_grid):
    """Cell k's rows spans[k, 0] .. + spans[k, 1] hold tri9 of its slots
    >= 0 in slot order (the float32 bits, each of v0, e1, e2 padded with a
    0); the starts are the running sum of the counts, so every filled slot
    has one row; the rows past the last are 0. A grid with other tables
    (dataclasses.replace) gets its own records."""
    grid = {"hall": lambda: hall_grid,
            "hall_holed": lambda: _holed(hall_grid),
            "random_holed": lambda: _holed(_grids("random")[1]),
            "colonnade_overflow": lambda: _grids("colonnade")[1]}[case]()
    rec, spans = grid.records, grid.spans
    filled = grid.cell_tris >= 0
    assert rec.dtype == torch.float32 and rec.shape == (filled.numel(), 12)
    assert spans.dtype == torch.int32 and spans.shape == (len(filled), 2)
    count = spans[:, 1].long()
    assert torch.equal(count, filled.sum(1))
    assert torch.equal(spans[:, 0].long(), torch.cumsum(count, 0) - count)
    tri9 = _tri9(grid)
    rows = torch.cat([rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]], -1)
    for k in range(len(filled)):
        ids = grid.cell_tris[k][filled[k]].long()
        got = rows[spans[k, 0]: spans[k, 0] + spans[k, 1]]
        assert torch.equal(got.view(torch.int32),
                           tri9[ids].view(torch.int32)), k
    total = int(count.sum())
    assert total == int(filled.sum())
    assert not rec[:, 3::4].any() and not rec[total:].any()
    if case == "hall":
        assert grid.dims == (48, 2, 5) and total == 7126
    if case.endswith("holed"):
        # holes before filled slots: the filled slots are not a prefix
        assert bool((~filled[:, :-1] & filled[:, 1:]).any())
        base = hall_grid if case == "hall_holed" else _grids("random")[1]
        assert grid.records is not base.records
        assert total < int((base.cell_tris >= 0).sum())


@pytest.mark.parametrize("pixels,dirs", [(540 * 960, 8), (33, 3), (1, 1),
                                         (64, 8), (100, 1), (31, 5)])
def test_lane_map_is_a_permutation(pixels, dirs):
    """The lane map R1 was measured against (chip_smoke.rt_lane_rays, warps
    of one direction of 32 consecutive pixels): every ray once, the padded
    threads of the last pixel group none; a warp's lanes hold one
    direction of consecutive pixels. The tiled maps (8x4 pixels, at stride
    1 and 4) on (h, w) = (pixels // 8, 8) where that divides: every ray
    once."""
    rays = chip_smoke.rt_lane_rays(pixels, dirs)
    n = pixels * dirs
    assert rays.numel() == -(-pixels // 32) * 32 * dirs
    kept = rays[rays >= 0]
    assert torch.equal(torch.sort(kept).values, torch.arange(n))
    warps = rays.reshape(-1, 32)
    for w in warps[:64]:
        live = w[w >= 0]
        assert torch.equal(live % dirs, torch.full_like(live, int(live[0])
                                                        % dirs))
        pix = live // dirs
        assert torch.equal(pix, torch.arange(int(pix[0]),
                                             int(pix[0]) + len(pix)))
    if pixels % 8 == 0:
        for stride in (1, 4):
            tiled = chip_smoke.tile_lane_rays(pixels // 8, 8, dirs, 8, 4,
                                              stride)
            kept = tiled[tiled >= 0]
            assert torch.equal(torch.sort(kept).values, torch.arange(n))


def _walk_case(case):
    _, grid = _grids("random")
    if case in EDGE_CASES:
        orig, d, t_max = _edge_rays(case, grid)
        return grid, orig, d, torch.from_numpy(t_max)
    _, grid = _grids("colonnade")
    lo = grid.grid_min.numpy()
    hi = lo + grid.cell_size.numpy() * np.asarray(grid.dims)
    orig, d, t_max = _rays(31, 3000, lo, hi, 0.1, 3.0)
    if case == "seeded_zero_d":
        return grid, orig, d, torch.tensor(1.25)
    if case == "seeded_holed":
        return _holed(grid), orig, d, torch.from_numpy(t_max)
    return grid, orig, d, torch.from_numpy(t_max)


@pytest.mark.parametrize("case", EDGE_CASES + ("seeded", "seeded_zero_d",
                                               "seeded_holed"))
def test_walk_with_early_exits_equals_the_reference(case):
    """rt_walk (the kernel's DDA over the slot records, each test leaving
    after det, before the division, after u or after v once it is a miss)
    gives ray_any_hit_reference's
    hits bit for bit, and its slot tests are the filled slots up to the
    first hit that rt_slot_tests counts for the bound; every exit path is
    taken."""
    grid, orig, d, t_max = _walk_case(case)
    o, dd = torch.from_numpy(orig), torch.from_numpy(d)
    for steps in (None, 3):
        hits, tests, left = chip_smoke.rt_walk(grid, o, dd, t_max,
                                               max_steps=steps)
        want = accel.ray_any_hit_reference(grid, o, dd, t_max,
                                           max_steps=steps)
        assert hits.dtype == torch.bool and torch.equal(hits, want)
        assert int(tests.sum()) == chip_smoke.rt_slot_tests(
            grid, o, dd, t_max, steps)
        assert sum(left.values()) == int(tests.sum())
    print(f"{case}: hit share {float(want.float().mean()):.4f}, tests "
          f"{int(tests.sum())}, exits {left}")
    if case == "non_finite":
        assert not want.any() and left["v"] == left["t"] == 0
        assert left["u"] > 0  # NaN a: past the test before the division
    else:
        assert 0.0 < float(want.float().mean()) < 1.0
        assert left["a"] > 0 and left["v"] > 0 and left["t"] > 0


def test_early_exits_never_settle_a_hit():
    """Each exit of the slot test alone, on slots where it is taken: after
    det (|det| < 1e-20 or NaN), before the division (a_rejects: |a| >
    |det| (1 + 2^-20), or opposite signs and |a| > |det| 2^-50), after u
    (u < 0, u > 1 or NaN) and after v (v < 0, u + v > 1 or NaN) the full
    test of the plain version is a miss, and the test before the division
    rejects no slot whose u = a * (1 / det) lies in [0, 1]. Seeded
    triangles and rays around them, with -0.0 and subnormal coordinates
    mixed in, and a and det drawn at the edges of the reject: u near 0
    and 1, products that round to +-0.0."""
    rng = np.random.default_rng(9)
    n = 20000
    f32 = np.float32
    v0 = rng.normal(size=(n, 3)).astype(f32)
    e1 = (rng.normal(size=(n, 3)) * 10.0 ** rng.integers(-8, 3, (n, 1))
          ).astype(f32)
    e2 = (rng.normal(size=(n, 3)) * 10.0 ** rng.integers(-8, 3, (n, 1))
          ).astype(f32)
    o = (v0 + rng.normal(size=(n, 3)) * 0.5).astype(f32)
    d = rng.normal(size=(n, 3)).astype(f32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    special = rng.choice([-0.0, 0.0, 1e-40, -1e-40], size=(n // 10, 3))
    d[: n // 10] = np.where(rng.random((n // 10, 3)) < 0.5, special,
                            d[: n // 10])
    o[n // 10: n // 5, 0] = np.nan
    o, d, v0, e1, e2 = map(torch.from_numpy, (o, d, v0, e1, e2))
    tm = torch.full((n,), 2.0)
    full = accel._tri_hit_mask(o, d, v0, e1, e2, tm)
    p = accel.cross(d, e2)
    det = accel.dot3(e1, p)
    ok_det = det.abs() >= 1e-20
    s = o - v0
    a = accel.dot3(s, p)
    ok_a = ok_det & ~chip_smoke.a_rejects(a, det)
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    u = a * inv
    ok_u = ok_a & (u >= 0.0) & ~(u > 1.0)
    v = accel.dot3(d, accel.cross(s, e1)) * inv
    ok_v = ok_u & (v >= 0.0) & (u + v <= 1.0)
    for passed in (ok_det, ok_a, ok_u, ok_v):
        assert not (full & ~passed).any()
    assert int((~ok_det).sum()) > 0 and int((ok_det & ~ok_a).sum()) > 0
    assert int((ok_u & ~ok_v).sum()) > 0 and int(full.sum()) > 0

    # a and det at the reject's edges: det of either sign over 2^-66..2^40,
    # a = det x (1 + k 2^-24) (u near 1) or det x 2^-e (u near 0, down to
    # products that round to 0), of either sign
    m = 200000
    det = torch.from_numpy((rng.choice([-1.0, 1.0], m) * 2.0 ** rng.uniform(
        -66, 40, m)).astype(f32))
    det = torch.where(det.abs() < 1e-20, det.sign() * 1e-20, det)
    k = torch.from_numpy(rng.integers(-40, 41, m).astype(f32))
    near_one = det * (1.0 + k * 2.0 ** -24)
    near_zero = (det.double() * torch.from_numpy(
        2.0 ** -rng.uniform(0, 200, m))).float()
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], m).astype(f32))
    for a in (near_one * sign, near_zero * sign):
        u = a * (1.0 / det)
        inside = (u >= 0.0) & (u <= 1.0)
        rejected = chip_smoke.a_rejects(a, det)
        assert not (rejected & inside).any()
        assert bool(rejected.any()) and bool(inside.any())
    # among them products that round to -0.0, which passes u >= 0
    assert bool(((u == 0.0) & (a < 0.0) & (det > 0.0)).any())
    zero = sign * 0.0  # +-0.0
    assert not chip_smoke.a_rejects(zero, det).any()


@pytest.mark.parametrize("case", ("seeded", "seeded_holed"))
def test_bound_counts_each_test_up_to_its_exit(case):
    """R1's operations bound (chip_smoke.work_of) charges each slot test
    the operations up to where it ends (MT_OPS by rt_walk's exits), which
    is less than PR 15's count of every test in full with its edges; its
    bytes are each ray's 25, the filled slot records' 48 and the spans."""
    grid, orig, d, t_max = _walk_case(case)
    o, dd = torch.from_numpy(orig), torch.from_numpy(d)
    nbytes, ops = chip_smoke.work_of("ray_any_hit", (grid, o, dd, t_max),
                                     {"max_steps": 3}, None)
    _, tests, left = chip_smoke.rt_walk(grid, o, dd, t_max, max_steps=3)
    assert ops == sum(chip_smoke.MT_OPS[k] * n for k, n in left.items())
    assert 14 * int(tests.sum()) <= ops < chip_smoke.MT_FLOPS_PR15 * int(
        tests.sum())
    filled = int((grid.cell_tris >= 0).sum())
    assert nbytes == (len(o) * 25 + filled * 48 + t_max.numel() * 4
                      + grid.spans.numel() * 4 + 6 * 4)


def test_parent_interface_is_checked(tmp_path):
    """build_r1_parent reads the parameter types of a source's
    vkr_ray_any_hit (chip_smoke.c_params) and takes only PR 15's
    interface or this tree's: any other fails before anything is built
    or called."""
    from vkr_tpu_torch import kernels

    mine = chip_smoke.c_params(kernels.CSRC / "ray_any_hit.cu")
    assert mine[:6] == ("const float*", "const float*", "float",
                        "const float*", "int", "int")
    assert len(mine) == 16 and mine[-2:] == ("unsigned char*", "void*")
    pr15 = tmp_path / "pr15.cu"
    pr15.write_text(
        'extern "C" int vkr_ray_any_hit(const float* orig, const float *dir,'
        '\n    float t_max, int n, const float* tri_verts,\n'
        '    const int* cell_tris, const float* grid_min,\n'
        '    const float* cell_size, int sx, int sy, int sz, int cap,\n'
        '    int max_steps, unsigned char* hit, void* stream) {\n}\n')
    assert chip_smoke.c_params(pr15) == chip_smoke.R1_PR15_PARAMS
    other = tmp_path / "other.cu"
    other.write_text(pr15.read_text().replace("int cap,", "int cap, int k,"))
    for src, what in ((other, "neither PR 15's interface"),
                      (tmp_path / "none.cu", "no extern")):
        if not src.exists():
            src.write_text("int main() { return 0; }\n")
        with pytest.raises(chip_smoke.SmokeFailure, match=what):
            chip_smoke.build_r1_parent(src)
