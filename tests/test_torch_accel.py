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
