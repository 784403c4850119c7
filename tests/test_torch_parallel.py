"""Multi-device rendering on the CPU (vkr_tpu_torch/parallel): the band
frame (render_frame_banded) and view parallelism (render_views_sharded)
against the port's one-device render_frame.

Every rank is a process (torch.multiprocessing, spawn) in a gloo group on a
free localhost port, one torch thread each. A session of ranks renders
every case of one size and hands numpy arrays back; the parent renders the
same frames on one device. Bounds (vkr_tpu's, tests/test_parallel.py): the
G-buffer and prev_depth bit for bit, colour and TAA history within 1e-6,
the ray-traced GTAO frame within 1e-5; the views equal render_frame's."""

import dataclasses
import queue
import socket
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

GBUF = ("albedo", "normal", "material", "velocity", "depth")
TIMEOUT_S = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _small(size=64, **cfg_kw):
    """vkr_tpu's test settings: the 2-column colonnade (tessellation 6,
    32^2 textures), SSR max_iterations 8, LUTs of 32, its camera."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=size, height=size, **cfg_kw)
    cfg = dataclasses.replace(cfg, ssr=dataclasses.replace(
        cfg.ssr, max_iterations=8))
    scene_np = colonnade_scene(columns=2, tessellation=6, tex_size=32)
    return cfg, scene_np, build_ssr_resources(32, device="cpu")


def _fixed_cams(cfg, n):
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.mathlib.transforms import look_at

    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    return [camera_frame(cfg, view, view, i, "cpu") for i in range(n)]


def _orbit_cams(cfg, n):
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    return [camera_frame(cfg, bench_orbit_view(i),
                         bench_orbit_view(max(i - 1, 0)), i, "cpu")
            for i in range(n)]


def _view_cams(cfg, n):
    """vkr_tpu's test_view_parallel_rendering cameras: n views around the
    2-column colonnade."""
    from vkr_tpu_torch.frame import camera_frame
    from vkr_tpu_torch.mathlib.transforms import look_at

    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (4 + 5 * np.cos(ang), 2.0, 0.5 + 3 * np.sin(ang))
        v = look_at(eye, (4, 1.8, 0.5), (0, -1, 0))
        cams.append(camera_frame(cfg, v, v, i, "cpu"))
    return cams


def _cases(kind):
    """(name, cfg, scene_np, res, cams, extra frame kwargs builder) of a
    session: 'small' on 4 ranks, 'hall' on 2."""
    from vkr_tpu_torch.config import GTAOConfig
    from vkr_tpu_torch.frame import build_probe_grid, build_scene_tri_grid
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    if kind == "hall":
        from vkr_tpu_torch.config import RenderConfig
        from vkr_tpu_torch.frame import build_ssr_resources

        cfg = RenderConfig(width=128, height=64)
        cfg = dataclasses.replace(cfg, ssr=dataclasses.replace(
            cfg.ssr, max_iterations=40))
        scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
        return [("hall", cfg, scene_np, build_ssr_resources(32, "cpu"),
                 _orbit_cams(cfg, 3), lambda: {})]
    cfg, scene_np, res = _small()
    cfg_probe = dataclasses.replace(cfg, enable_probes=True, probes=(
        dataclasses.replace(cfg.probes, grid=2, cube_size=16, oct_size=32)))
    cfg_rt = dataclasses.replace(
        cfg, enable_ssr=False, enable_taa=False,
        gtao=GTAOConfig(use_ray_query=True, rt_directions=8))
    return [
        ("default", cfg, scene_np, res, _fixed_cams(cfg, 3), lambda: {}),
        ("probe", cfg_probe, scene_np, res, _fixed_cams(cfg, 2),
         lambda: {"probe_grid": build_probe_grid(
             scene_np, cfg_probe, use_kernels=True, device="cpu")}),
        ("rt", cfg_rt, scene_np, res, _fixed_cams(cfg, 1),
         lambda: {"tri_grid": build_scene_tri_grid(
             scene_np, resolution=12, cap=32, device="cpu")}),
    ]


def _frames(render, cfg, scene, res, cams, extra):
    """Frames of `cams` from a fresh state through render(scene, state,
    cam, res, cfg, **extra): per frame the colour, the G-buffer, the new
    state's prev_depth and TAA history, the overflow and the SSR rays, as
    numpy arrays."""
    from vkr_tpu_torch.core.framestate import FrameState

    state = FrameState.initial(cfg.height, cfg.width, "cpu")
    out = []
    for cam in cams:
        color, state, aux = render(scene, state, cam, res, cfg, **extra)
        f = {k: getattr(aux["gbuffer"], k).numpy() for k in GBUF}
        f.update(color=color.numpy(), prev_depth=state.prev_depth.numpy(),
                 taa_history=state.taa_history.numpy(),
                 overflow=int(aux["overflow"]), ao=aux["ao"].numpy())
        if aux["ssr_rays"] is not None:
            f["ssr_rays"] = aux["ssr_rays"].numpy()
        if aux["probe"] is not None:
            f["probe"] = aux["probe"].numpy()
        out.append(f)
    return out


def _session(rank, n, kind, views):
    """One rank's share of a session: every case of `kind` banded, the
    overflow sum, and, given vkr_tpu's batched cameras and states as numpy
    (views), the view-parallel frames."""
    import torch.distributed as dist

    from vkr_tpu_torch.convert import (camera_frame_from_numpy,
                                       framestate_from_numpy)
    from vkr_tpu_torch.parallel import (make_render_mesh,
                                        render_frame_banded,
                                        render_views_sharded)
    from vkr_tpu_torch.parallel.band import RowGather
    from vkr_tpu_torch.passes.gbuffer import upload_scene

    out = {}
    for name, cfg, scene_np, res, cams, extra in _cases(kind):
        out[name] = _frames(
            lambda *a, **kw: render_frame_banded(*a, device="cpu", **kw),
            cfg, upload_scene(scene_np, "cpu"), res, cams, extra())
    out["sum"] = int(RowGather(None, "cpu").sum(
        torch.tensor(rank + 1, dtype=torch.int32)))
    if views is not None:
        cfg, scene_np, res = _small()
        mesh = make_render_mesh(device="cpu")
        cams, states = views
        colors, states = render_views_sharded(
            upload_scene(scene_np, "cpu"),
            framestate_from_numpy(states, "cpu"),
            camera_frame_from_numpy(cams, "cpu"), res, cfg, mesh)
        out["views"] = dict(colors=colors.numpy(),
                            prev_depth=states.prev_depth.numpy(),
                            frame_index=states.frame_index.numpy())
    dist.barrier()
    return out


def _rank_main(rank, n, port, kind, views, q):
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=n, rank=rank)
        q.put((rank, _session(rank, n, kind, views)))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))


def _run(n, kind, views=None):
    """Spawn n ranks of a session; their results in rank order. Every
    process is stopped before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, kind, views, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results, waited = {}, 0
    try:
        while len(results) < n:
            try:
                rank, res = q.get(timeout=5)
            except queue.Empty:
                waited += 5
                missing = sorted(set(range(n)) - set(results))
                dead = [r for r in missing if not procs[r].is_alive()]
                assert not dead, f"ranks {dead} died without a result"
                assert waited < TIMEOUT_S, f"no result from ranks {missing}"
                continue
            assert "error" not in res, f"rank {rank}:\n{res['error']}"
            results[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def _one_device(kind):
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene

    return {name: _frames(render_frame, cfg, upload_scene(scene_np, "cpu"),
                          res, cams, extra())
            for name, cfg, scene_np, res, cams, extra in _cases(kind)}


def _vkr_tpu_views(n):
    """vkr_tpu's batched cameras and states for the views (its camera_frame,
    batch_cams and batch_states), as numpy: what both packages take."""
    import jax.numpy as jnp

    from vkr_tpu.config import RenderConfig
    from vkr_tpu.core.framestate import FrameState
    from vkr_tpu.frame import camera_frame
    from vkr_tpu.mathlib import look_at
    from vkr_tpu.parallel.sharding import batch_cams, batch_states

    cfg = RenderConfig(width=64, height=64)
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (4 + 5 * np.cos(ang), 2.0, 0.5 + 3 * np.sin(ang))
        v = look_at(eye, (4, 1.8, 0.5), (0, -1, 0))
        cams.append(camera_frame(cfg, v, v, i))
    cams = batch_cams(cams)
    states = batch_states(lambda: FrameState.initial(64, 64), n)
    assert isinstance(states.frame_index, jnp.ndarray)
    return (types.SimpleNamespace(**{f: np.asarray(getattr(cams, f))
                                     for f in cams._fields}),
            {f: np.asarray(getattr(states, f)) for f in states.FIELDS})


@pytest.fixture(scope="module")
def small():
    views = _vkr_tpu_views(4)
    return _run(4, "small", views), _one_device("small"), views


@pytest.fixture(scope="module")
def hall():
    return _run(2, "hall"), _one_device("hall")


def _hold(banded, single, color_atol=1e-6, history=True):
    assert len(banded) == len(single)
    for i, (b, s) in enumerate(zip(banded, single)):
        for k in GBUF + ("prev_depth",):
            np.testing.assert_array_equal(b[k], s[k], err_msg=f"frame {i} {k}")
        assert b["overflow"] == s["overflow"] == 0
        np.testing.assert_allclose(b["color"], s["color"], rtol=0,
                                   atol=color_atol, err_msg=f"frame {i}")
        if history:
            np.testing.assert_allclose(b["taa_history"], s["taa_history"],
                                       rtol=0, atol=color_atol)


@pytest.mark.parametrize("case", ["default", "probe"])
def test_band_frame_matches_one_device(small, case):
    """4 ranks at 64x64 (vkr_tpu's test_band_sharded_frame_bit_matches_
    single_device, 3 frames; and its probe frame, 2 frames over the port's
    2x2 grid of 16^2 faces). Every rank returns the whole frame."""
    ranks, single, _ = small
    for r, out in enumerate(ranks):
        _hold(out[case], single[case])
    if case == "probe":
        assert all((f["probe"][..., 3] > 0).mean() > 0.01
                   for f in single["probe"])


def test_band_frame_ray_traced_gtao(small):
    """vkr_tpu's test_band_frame_with_ray_query_gtao: 4 ranks, SSR and TAA
    off, 8 ray-query directions over a grid of 12^3 cells; colour within
    vkr_tpu's 1e-5."""
    ranks, single, _ = small
    for out in ranks:
        _hold(out["rt"], single["rt"], color_atol=1e-5, history=False)
    assert single["rt"][0]["ao"].std() > 0.01


def test_band_frame_hall_ssr_in_every_band(hall):
    """2 ranks at 128x64 in the 24-column hall, 3 frames of the bench
    orbit: SSR rays hit in both bands, so every band form of the SSR chain
    runs on real reflections."""
    ranks, single = hall
    for out in ranks:
        _hold(out["hall"], single["hall"])
    for f in single["hall"]:
        valid = f["ssr_rays"][..., 3] != 1.0
        per_band = [float(v.mean()) for v in np.split(valid, 2)]
        assert min(per_band) > 0.02, per_band


def test_overflow_is_summed(small):
    """RowGather.sum, the band frame's overflow all_reduce: 1+2+3+4."""
    assert [out["sum"] for out in small[0]] == [10] * 4


def test_views_sharded_match_render_frame(small):
    """vkr_tpu's test_view_parallel_rendering on 4 ranks, from vkr_tpu's
    batched cameras and states carried across (convert.py; the port's
    batch_cams and batch_states make the same): view v on rank v, each
    equal to a one-device render_frame of its camera from a fresh state;
    every rank returns all four."""
    from vkr_tpu_torch.convert import (camera_frame_from_numpy,
                                       framestate_from_numpy)
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.parallel import batch_cams, batch_states
    from vkr_tpu_torch.passes.gbuffer import upload_scene

    cfg, scene_np, res = _small()
    cams = camera_frame_from_numpy(small[2][0], "cpu")
    for a, b in zip(cams, batch_cams(_view_cams(cfg, 4))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    states = framestate_from_numpy(small[2][1], "cpu")
    ours = batch_states(lambda: FrameState.initial(64, 64, "cpu"), 4)
    assert states.frame_index.dtype == ours.frame_index.dtype == torch.int32
    assert (states.frame_index.tolist() == ours.frame_index.tolist()
            == [0, 0, 0, 0])
    for name in FrameState.FIELDS[:-1]:
        assert torch.equal(getattr(states, name), getattr(ours, name)), name
    scene = upload_scene(scene_np, "cpu")
    want = [render_frame(scene, FrameState.initial(64, 64, "cpu"),
                         type(cams)(*(t[v] for t in cams)), res, cfg)
            for v in range(4)]
    for out in small[0]:
        v = out["views"]
        assert v["colors"].shape == (4, 64, 64, 3)
        assert v["frame_index"].dtype == np.int32
        assert v["frame_index"].tolist() == [1, 1, 1, 1]
        for i, (color, state, _) in enumerate(want):
            np.testing.assert_array_equal(v["colors"][i], color.numpy())
            np.testing.assert_array_equal(v["prev_depth"][i],
                                          state.prev_depth.numpy())
    cov = (v["prev_depth"] < 1.0).reshape(4, -1).mean(1)
    assert cov.min() > 0.05
    assert not np.allclose(v["colors"][0], v["colors"][1])


def test_batch_and_unbatch():
    """batch_states / batch_cams stack on a new leading axis and
    unbatch_state takes one view back."""
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import batch_cams, batch_states
    from vkr_tpu_torch.parallel.sharding import unbatch_state

    cfg, _, _ = _small()
    states = batch_states(lambda: FrameState.initial(8, 6, "cpu"), 3)
    assert states.taa_history.shape == (3, 8, 6, 3)
    assert states.frame_index.dtype == torch.int32
    assert states.frame_index.tolist() == [0, 0, 0]
    one = unbatch_state(states, 2)
    assert one.frame_index.shape == () and int(one.frame_index) == 0
    assert one.prev_depth.shape == (8, 6)
    cams = _view_cams(cfg, 3)
    b = batch_cams(cams)
    assert b.mvp.shape == (3, 4, 4) and b.jitter.shape == (3, 2)
    assert torch.equal(b.view[1], cams[1].view)


def test_band_needs_even_bands():
    """A frame whose rows do not split into even bands is refused, as
    vkr_tpu asserts h % (2 n) == 0."""
    from unittest import mock

    from vkr_tpu_torch.parallel import band

    with mock.patch.object(band.dist, "get_world_size", return_value=4), \
            mock.patch.object(band.dist, "get_rank", return_value=1):
        assert band.band_rows(64) == (16, 16)
        with pytest.raises(ValueError, match="even"):
            band.band_rows(60)
