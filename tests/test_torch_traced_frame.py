"""The traced frame (core/aot.py:cached_jit) on the CPU.

On the card cached_jit captures the frame into CUDA graphs and replays
them; the CPU has no graph, so these tests hold the parts a graph relies
on: the frame counter and its per-frame values on the device, bit for bit
the host-int frames they replace; the binning at a static capacity
(raster/setup.py:pair_plan), bit for bit the exact frame at or above the
count and vkr_tpu's overflow below it; no host read inside the frame; and
CapturedFrame's control flow with a fake graph whose replay reruns the
recorded body. chip_smoke.py's traced phase holds the real graphs on the
card."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)

W, H = 256, 128
N_FRAMES = 4
LUT_SIZE = 64
# The parent's host-int logic for frames 0-3 of the default frame: the
# GTAO base angle (float(np.float32(...)) of the old
# passes/gtao.py:frame_base_angle), the SSR halton counter frame % 128 and
# the history clear on frame 0 only.
HOST_BASE_ANGLES = (float.fromhex("-0x1.8e66240000000p-4"),
                    float.fromhex("0x1.2ffbc20000000p+0"),
                    float.fromhex("0x1.e377980000000p-2"),
                    float.fromhex("0x1.07002c0000000p-2"))
HOST_FRAME_RANDOM = (0, 1, 2, 3)
HOST_CLEAR_HISTORY = (True, False, False, False)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _tensors(color, state, aux):
    """Every tensor a frame returns, in a fixed order."""
    g = aux["gbuffer"]
    return ([color] + [getattr(state, f) for f in state.FIELDS]
            + [aux[k] for k in ("hiz_depth", "ssr", "ao", "overflow")]
            + list(g))


def _equal(got, want):
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(got, want))


@pytest.fixture(scope="module")
def hall():
    """The default frame (SSR on, MIS GTAO, TAA, two mask layers,
    quantized) in the 24-column hall at 256x128, and its cameras."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources, camera_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=32), "cpu")
    res = build_ssr_resources(LUT_SIZE, device="cpu")
    cams = [camera_frame(cfg, bench_orbit_view(i),
                         bench_orbit_view(max(i - 1, 0)), i, "cpu")
            for i in range(N_FRAMES)]
    return scene, res, cfg, cams


@pytest.fixture(scope="module")
def exact(hall):
    """The eager frames 0-3 with the exact bin-pair lists: each frame's
    tensors (cloned) and its binning calls' pair counts."""
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.raster import setup

    scene, res, cfg, cams = hall
    state = FrameState.initial(H, W, "cpu")
    out, counts = [], []
    for cam in cams:
        plan = setup.PairPlan()
        with setup.pair_plan(plan):
            color, state, aux = render_frame(scene, state, cam, res, cfg)
        out.append([t.clone() for t in _tensors(color, state, aux)])
        counts.append(plan.counts)
    return out, counts


# ------------------------------------------------------------ (a) the angle

def test_frame_base_angle_equals_vkr_tpu_bit_for_bit():
    """The device base angle of frames 0-4,095 and of indices around each
    wrap of index * 2654435761 past 2^32 (and the int32 extremes) equals
    vkr_tpu's frame_base_angle bit for bit: a 0-d float32 tensor per
    index, the same function on a (N,) int32 tensor."""
    from vkr_tpu.passes import gtao as jgtao
    from vkr_tpu_torch.passes import gtao as tgtao

    wraps = [(k << 32) // 2654435761 for k in range(1, 1 << 31, 1 << 21)]
    near = sorted({i + d for i in wraps for d in (-1, 0, 1)
                   if 0 <= i + d < 2 ** 31})
    idx = np.asarray(list(range(4096)) + near
                     + [2 ** 31 - 1, -1, -2 ** 31, -12345], np.int32)
    want = np.asarray(jax.jit(jgtao.frame_base_angle)(jnp.asarray(idx)))
    got = tgtao.frame_base_angle(torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    for i in (0, 1, 2, 3, 4095, int(near[0]), 2 ** 31 - 1):
        one = tgtao.frame_base_angle(torch.tensor(i, dtype=torch.int32))
        assert one.shape == () and one.dtype == torch.float32
        assert one.numpy().view(np.uint32) == np.float32(
            jgtao.frame_base_angle(jnp.int32(i))).view(np.uint32), i
    assert [float(tgtao.frame_base_angle(i)) for i in range(4)] == list(
        HOST_BASE_ANGLES)


# ---------------------------------------- (b) device counter = host ints

def test_device_counter_equals_the_host_int_frames(hall, exact):
    """Frames 0-3 with the device frame counter (the exact eager frames)
    equal, bit for bit, the same frames run on the parent's host-int
    logic: the held base angles, halton counters and history clears
    handed to the passes as Python scalars."""
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.passes import gtao, ssr

    scene, res, cfg, cams = hall
    seen = []
    accumulate, trace = gtao.gtao_accumulate, ssr.ssr_trace

    def host_accumulate(*a, clear_history, **kw):
        seen.append(("clear", bool(clear_history)))
        return accumulate(*a, clear_history=bool(clear_history), **kw)

    def host_trace(hiz, normal, material, lut, params, frame_random, *a,
                   **kw):
        seen.append(("random", int(frame_random)))
        return trace(hiz, normal, material, lut, params, int(frame_random),
                     *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gtao, "frame_base_angle",
                   lambda index: HOST_BASE_ANGLES[int(index)])
        mp.setattr(gtao, "gtao_accumulate", host_accumulate)
        mp.setattr(ssr, "ssr_trace", host_trace)
        state = FrameState.initial(H, W, "cpu")
        for i, cam in enumerate(cams):
            color, state, aux = render_frame(scene, state, cam, res, cfg)
            assert _equal(_tensors(color, state, aux), exact[0][i]), i
    assert [v for k, v in seen if k == "clear"] == list(HOST_CLEAR_HISTORY)
    assert [v for k, v in seen if k == "random"] == list(HOST_FRAME_RANDOM)
    assert state.frame_index.dtype == torch.int32
    assert int(state.frame_index) == N_FRAMES


# ---------------------------------------------- (c) the static capacity

def test_static_capacity_equals_the_exact_frame(hall, exact):
    """The binning at a static capacity at or above each call's pair count
    (the count itself, and the captured frame's count * PAIR_HEADROOM of
    frame 0) gives frames 1-3 equal to the exact eager frames bit for bit,
    overflow 0."""
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.raster import setup

    scene, res, cfg, cams = hall
    frames, counts = exact
    static = setup.static_capacities(counts[0])
    assert len(static) == 2  # the opaque and masked binning; peel reruns
    assert static == [max(int(np.ceil(c * setup.PAIR_HEADROOM)),
                          setup.PAIR_FLOOR) for c in counts[0]]
    for label in ("count", "static"):
        for i in range(1, N_FRAMES):
            caps = counts[i] if label == "count" else static
            assert all(c >= n for c, n in zip(caps, counts[i]))
            prev = frames[i - 1]
            state = _state(prev)
            with setup.pair_plan(setup.PairPlan(caps)):
                color, state, aux = render_frame(scene, state, cams[i], res,
                                                 cfg)
            assert _equal(_tensors(color, state, aux), frames[i]), (label, i)
            assert int(aux["overflow"]) == 0


def _state(tensors):
    """The FrameState among a frame's _tensors."""
    from vkr_tpu_torch.core.framestate import FrameState

    n = len(FrameState.FIELDS)
    return FrameState(**dict(zip(FrameState.FIELDS, tensors[1:1 + n])))


def test_overflow_below_the_count_is_vkr_tpus(hall, exact):
    """At half of frame 1's pair counts the frame's overflow is the sum of
    what vkr_tpu's bin_triangles_t (the SoA path of its pipeline.py:167)
    reports at those capacities on the same bounding boxes, and each
    binning call's lists equal vkr_tpu's."""
    from vkr_tpu.raster import setup as jsetup
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.raster import setup

    scene, res, cfg, cams = hall
    frames, counts = exact
    caps = [n // 2 for n in counts[1]]
    calls = []
    binning = setup.bin_triangles_t

    def recorded(bbox, valid, width, height, tile_h, tile_w, cap):
        out = binning(bbox, valid, width, height, tile_h, tile_w, cap)
        calls.append(([b.clone() for b in bbox], valid.clone(), width,
                      height, tile_h, tile_w, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(setup, "bin_triangles_t", recorded)
        with setup.pair_plan(setup.PairPlan(caps)):
            _, _, aux = render_frame(scene, _state(frames[0]), cams[1], res,
                                     cfg)
    assert len(calls) == len(caps) == 2
    total = 0
    for (bbox, valid, w, h, th, tw, got), cap in zip(calls, caps):
        want = jsetup.bin_triangles_t([jnp.asarray(b.numpy()) for b in bbox],
                                      jnp.asarray(valid.numpy()), w, h, th,
                                      tw, cap)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        total += int(want[3])
    assert total == sum(n - c for n, c in zip(counts[1], caps)) > 0
    assert int(aux["overflow"]) == total


# ------------------------------------------------------ (d) no host read

# what no_host_read replaced, while it is in force (allow_host_read
# restores them for a while)
_REFUSED = []


@contextlib.contextmanager
def no_host_read():
    """Make every way a frame could read a tensor on the host, or copy a
    Python list to a device, raise."""
    def refuse(name):
        def fail(*a, **kw):
            raise AssertionError(f"host read inside the traced body: {name}")
        return fail

    targets = [(torch.Tensor, n) for n in (
        "__int__", "__bool__", "__float__", "__index__", "item", "tolist",
        "cpu", "numpy")] + [(torch, "tensor"), (torch, "as_tensor")]
    saved = [(o, n, getattr(o, n)) for o, n in targets]
    _REFUSED.append(saved)
    try:
        for o, n in targets:
            setattr(o, n, refuse(n))
        yield
    finally:
        _REFUSED.pop()
        for o, n, v in saved:
            setattr(o, n, v)


@contextlib.contextmanager
def allow_host_read():
    """Inside no_host_read: lift it while the block runs."""
    saved = _REFUSED[-1]
    refused = [(o, n, getattr(o, n)) for o, n, _ in saved]
    try:
        for o, n, v in saved:
            setattr(o, n, v)
        yield
    finally:
        for o, n, v in refused:
            setattr(o, n, v)


def test_traced_body_reads_nothing_from_the_host(hall, exact):
    """Frames 1-3 of the traced body (the frame at frame 0's static
    capacities) run with every host read and list-to-device copy made to
    raise, and still equal the exact frames."""
    from vkr_tpu_torch.frame import render_frame
    from vkr_tpu_torch.raster import setup

    scene, res, cfg, cams = hall
    frames, counts = exact
    caps = setup.static_capacities(counts[0])
    state = _state(frames[0])
    for i in range(1, N_FRAMES):
        with setup.pair_plan(setup.PairPlan(caps)), no_host_read():
            color, state, aux = render_frame(scene, state, cams[i], res, cfg)
        assert _equal(_tensors(color, state, aux), frames[i]), i
    with pytest.raises(AssertionError, match="host read"), no_host_read():
        int(torch.ones(()))


def test_traced_rt_body_reads_nothing_from_the_host(small, monkeypatch):
    """The ray-traced GTAO frame: frames 1-3 of its traced body (frame 0's
    static capacities) with every host read made to raise, except inside
    accel.ray_any_hit, swapped for its plain version run with host reads
    allowed (on the card it is csrc/ray_any_hit.cu, which reads nothing
    from the host), equal the exact frames: the rest of the RT frame
    (gtao_rt's preamble, the direction table, the AO sum) reads nothing
    from the host."""
    import dataclasses

    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import build_scene_tri_grid, render_frame
    from vkr_tpu_torch.raster import setup
    from vkr_tpu_torch.scene import accel
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    scene, res, cfg, cams = small
    rt = dataclasses.replace(cfg, gtao=dataclasses.replace(
        cfg.gtao, use_ray_query=True))
    grid = build_scene_tri_grid(colonnade_scene(columns=24, tessellation=4,
                                                tex_size=16),
                                resolution=16, cap=8, device="cpu")
    state, frames, counts = FrameState.initial(24, 48, "cpu"), [], []
    for cam in cams[:4]:
        plan = setup.PairPlan()
        with setup.pair_plan(plan):
            color, state, aux = render_frame(scene, state, cam, res, rt,
                                             tri_grid=grid)
        frames.append([t.clone() for t in _tensors(color, state, aux)])
        counts.append(plan.counts)

    calls = []

    def plain(*args, **kw):
        calls.append(kw.get("max_steps"))
        with allow_host_read():
            return accel.ray_any_hit_reference(*args, **kw)

    monkeypatch.setattr(accel, "ray_any_hit", plain)
    caps = setup.static_capacities(counts[0])
    state = _state(frames[0])
    for i in range(1, 4):
        with setup.pair_plan(setup.PairPlan(caps)), no_host_read():
            color, state, aux = render_frame(scene, state, cams[i], res, rt,
                                             tri_grid=grid)
        assert _equal(_tensors(color, state, aux), frames[i]), i
    assert calls == [12] * 8 * 3  # gtao_rt's 8 chunks of 8 directions


# ------------------------------------------- (e) the capture's control flow

class FakeGraph:
    """A graph whose replay reruns the recorded body and writes its results
    into the tensors the capture returned, as a CUDA graph writes its
    outputs in place."""

    def __init__(self, log, run, out):
        self.log, self.run, self.out = log, run, out

    def replay(self):
        from vkr_tpu_torch.core.aot import _flat

        self.log.append("replay")
        for dst, src in zip(_flat(self.out), _flat(self.run())):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)


class FakeEvent:
    def query(self):
        return True

    def synchronize(self):
        pass


class FakeGraphs:
    """aot._CudaGraphs on the CPU: warm-up, capture, events and pinned
    memory, each call logged."""

    device_type = "cpu"

    def __init__(self):
        self.log = []

    def warm_up(self, run):
        self.log.append("warm_up")
        return run()

    def capture(self, run):
        self.log.append("capture")
        out = run()
        return FakeGraph(self.log, run, out), out

    def event(self):
        return FakeEvent()

    def pinned(self, n):
        return torch.zeros(n, dtype=torch.int32)

    def release(self):
        self.released = getattr(self, "released", 0) + 1


@pytest.fixture(scope="module")
def small():
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources, camera_frame
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.orbit import bench_orbit_view
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=48, height=24)
    scene = upload_scene(colonnade_scene(columns=24, tessellation=4,
                                         tex_size=16), "cpu")
    res = build_ssr_resources(16, device="cpu")
    cams = [camera_frame(cfg, bench_orbit_view(i),
                         bench_orbit_view(max(i - 1, 0)), i, "cpu")
            for i in range(5)]
    return scene, res, cfg, cams


def test_captured_frame_control_flow(small):
    """Warm-up, then two captures, then a replay per call; the donated
    state ping-pongs between two sets (the state a call returns is the
    next graph's input, passed back without a copy); a call's colour
    survives the next call and is overwritten by the one after; the
    frames equal the eager ones bit for bit; clear_jit_caches() and
    reload() drop the graphs, and the next call captures anew."""
    from vkr_tpu_torch.core import aot, registry
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame

    scene, res, cfg, cams = small
    state = FrameState.initial(24, 48, "cpu")
    eager = []
    for cam in cams:
        color, state, aux = render_frame(scene, state, cam, res, cfg)
        eager.append([t.clone() for t in _tensors(color, state, aux)])

    graphs = FakeGraphs()
    frame = aot.CapturedFrame(
        "test_frame", lambda s, st, c: render_frame(s, st, c, res, cfg),
        donate_argnums=(1,), graphs=graphs)
    registry.track_jit(frame)
    first = FrameState.initial(24, 48, "cpu")
    state, colors, sets = first, [], []
    for i, cam in enumerate(cams[:4]):
        color, state, aux = frame(scene, state, cam)
        assert _equal(_tensors(color, state, aux), eager[i]), i
        colors.append((color, color.clone()))
        sets.append(state)
        if i >= 1:  # the previous call's colour survives this call
            assert torch.equal(*colors[i - 1])
    assert graphs.log == ["warm_up", "capture", "capture"] + ["replay"] * 4
    assert sets[0] is sets[2] and sets[1] is sets[3] and sets[0] is not sets[1]
    assert not torch.equal(colors[0][0], colors[0][1])  # call 3 rewrote it
    assert int(first.frame_index) == 0  # copied in, not written
    assert frame.capacities == [4096, 4096] and frame.capture_seconds > 0

    # a state other than the one returned is copied into the next set
    color, again, _ = frame(scene, FrameState.initial(24, 48, "cpu"),
                            cams[0])
    assert torch.equal(color, eager[0][0]) and int(again.frame_index) == 1

    for drop in (registry.clear_jit_caches, registry.reload):
        graphs.log.clear()
        drop()
        color, state, aux = frame(scene, FrameState.initial(24, 48, "cpu"),
                                  cams[0])
        assert graphs.log == ["warm_up", "capture", "capture", "replay"]
        assert torch.equal(color, eager[0][0])
    registry._TRACKED_JITS.discard(frame)


def test_captured_frame_overflow_and_arguments():
    """A replay's overflow is read at the next call, which raises naming
    the call and the count; a large argument tensor, or a value that is
    not a tensor, must be the captured call's, and small tensors are
    copied in at every call."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState

    def fn(x, state, big, scale):
        new = state.replace(prev_depth=state.prev_depth + big[:2, :2].sum(),
                            frame_index=state.frame_index + 1)
        return x * scale, new, {"overflow": x[0].to(torch.int32)}

    state = FrameState.initial(4, 4, "cpu")
    big = torch.ones(200, 200)  # 160,000 bytes: read in place
    frame = aot.CapturedFrame("overflow", fn, donate_argnums=(1,),
                              graphs=FakeGraphs())
    y, state, aux = frame(torch.zeros(3), state, big, 2.0)
    y, state, aux = frame(torch.tensor([5.0, 1.0, 1.0]), state, big, 2.0)
    assert y.tolist() == [10.0, 2.0, 2.0] and int(aux["overflow"]) == 5
    assert int(state.frame_index) == 2
    assert float(state.prev_depth[0, 0]) == 9.0
    with pytest.raises(RuntimeError, match=r"call 2 dropped 5 bin pairs"):
        frame(torch.zeros(3), state, big, 2.0)

    frame = aot.CapturedFrame("args", fn, donate_argnums=(1,),
                              graphs=FakeGraphs())
    _, state, _ = frame(torch.zeros(3), state, big, 2.0)
    with pytest.raises(ValueError, match="not the captured call's"):
        frame(torch.zeros(3), state, big.clone(), 2.0)
    with pytest.raises(ValueError, match="not the captured call's"):
        frame(torch.zeros(3), state, big, 3.0)
    with pytest.raises(NotImplementedError):
        aot.CapturedFrame("two", fn, donate_argnums=(0, 1))


def test_captured_frame_takes_a_tri_grid_among_its_arguments():
    """A TriGrid among a CapturedFrame's arguments: the capture flattens it
    (_flat rebuilds it with None leaves, which leaves its slot records
    None), and every replay gives the eager hits; a grid with the same
    large vertex table but other cells is copied in with its own slot
    records, and a grid with another vertex table is refused."""
    import dataclasses

    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.scene import accel

    rng = np.random.default_rng(4)
    # 2,000 triangles: a 72,000-byte vertex table, read in place
    tris = rng.uniform(-1.0, 1.0, (2000, 1, 3)) + rng.normal(
        0.0, 0.05, (2000, 3, 3))
    grid = accel.build_tri_grid(tris.reshape(-1, 3),
                                np.arange(6000).reshape(-1, 3),
                                resolution=6, cap=8, device="cpu")
    assert grid.tri_verts.numel() * 4 > aot.INPUT_BYTES
    flat = aot._flat((grid,))
    assert any(leaf is grid.records for leaf in flat)
    assert aot._map(grid, lambda leaf: None).records is None
    o = torch.from_numpy(rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))

    def fn(g, orig, dirs):
        return accel.ray_any_hit(g, orig, dirs, 0.7, max_steps=4)

    frame = aot.CapturedFrame("grid", fn, graphs=FakeGraphs())
    for _ in range(3):
        assert torch.equal(frame(grid, o, d), fn(grid, o, d))
    # other cells over the same vertex table: the small tables and the
    # slot records follow the call's grid
    other = dataclasses.replace(grid, cell_tris=torch.where(
        grid.cell_tris % 2 == 0, -1, grid.cell_tris))
    assert not torch.equal(fn(other, o, d), fn(grid, o, d))
    assert torch.equal(frame(other, o, d), fn(other, o, d))
    assert torch.equal(frame(grid, o, d), fn(grid, o, d))
    with pytest.raises(ValueError, match="not the captured call's"):
        frame(dataclasses.replace(grid, tri_verts=grid.tri_verts.clone()),
              o, d)


def test_ray_traced_frame_runs_eagerly_by_rule(small, monkeypatch):
    """The rule is gone: cached_jit on (what it takes for) CUDA arguments
    captures the ray-traced GTAO frame like any other (its any-hit walk is
    csrc/ray_any_hit.cu on the card, a launch of fixed shape). All four
    combinations of a RenderConfig with or without gtao.use_ray_query and
    a TriGrid or none, closed over by fn or among example_args, come back
    as a CapturedFrame."""
    import dataclasses
    import types

    from vkr_tpu_torch.core import aot, registry
    from vkr_tpu_torch.frame import build_scene_tri_grid, render_frame
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    scene, res, cfg, cams = small
    monkeypatch.setattr(aot, "_leaves", lambda tree: [
        types.SimpleNamespace(is_cuda=True)])
    monkeypatch.setenv("VKR_AOT", "0")
    grid = build_scene_tri_grid(colonnade_scene(columns=2, tessellation=4,
                                                tex_size=16),
                                resolution=8, cap=4, device="cpu")
    rt = dataclasses.replace(cfg, gtao=dataclasses.replace(
        cfg.gtao, use_ray_query=True))

    def closing(c, g):
        return lambda s, st, cam: render_frame(s, st, cam, res, c,
                                               tri_grid=g)

    args = (scene, None, cams[0])
    made = []
    for c in (rt, cfg):
        for g in (grid, None):
            made.append(aot.cached_jit("frame", closing(c, g), args))
            made.append(aot.cached_jit("frame", render_frame,
                                       (scene, None, cams[0], res, c, g)))
    assert all(isinstance(f, aot.CapturedFrame) for f in made)
    assert not hasattr(aot, "_ray_traced")
    for f in made:
        registry._TRACKED_JITS.discard(f)


def test_traced_frames_against_vkr_tpu():
    """Frames 1-3 of the traced SSR-off frame (CapturedFrame with the fake
    graph: replays of the body at frame 0's static capacities) at
    256x128 against vkr_tpu's jitted render_frame(use_pallas=False), at
    test_torch_frame.py's bar: >= 40 dB per G-buffer channel, AO and
    colour."""
    from vkr_tpu.config import RenderConfig as JConfig
    from vkr_tpu.core.framestate import FrameState as JState
    from vkr_tpu.frame import SSRResources as JRes
    from vkr_tpu.frame import camera_frame as j_camera
    from vkr_tpu.frame import render_frame as j_render
    from vkr_tpu.mathlib.brdf import halton23_table
    from vkr_tpu.passes import ssr as jssr
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import (build_ssr_resources, camera_frame,
                                     render_frame)
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    scene_np = colonnade_scene(columns=6, tessellation=8, tex_size=32)
    jcfg = JConfig(width=W, height=H, enable_ssr=False)
    cfg = RenderConfig(width=W, height=H, enable_ssr=False)
    jres = JRes(pdf_lut=jnp.zeros((LUT_SIZE, LUT_SIZE), jnp.float32),
                brdf_lut=jssr.preintegrate_brdf(LUT_SIZE),
                halton=jnp.asarray(halton23_table(jssr.HALTON_SEQ_SIZE)))
    jscene = j_upload(scene_np)
    jframe = jax.jit(lambda s, st, c: j_render(s, st, c, jres, jcfg,
                                               use_pallas=False))
    res = build_ssr_resources(LUT_SIZE, device="cpu")
    scene = scene_from_numpy(scene_np, "cpu")
    graphs = FakeGraphs()
    frame = aot.CapturedFrame(
        "vs_vkr_tpu", lambda s, st, c: render_frame(s, st, c, res, cfg),
        donate_argnums=(1,), graphs=graphs)
    jstate, state = JState.initial(H, W), FrameState.initial(H, W, "cpu")
    for i in range(N_FRAMES):
        view, prev = bench_orbit_view(i), bench_orbit_view(max(i - 1, 0))
        jcolor, jstate, jaux = jframe(jscene, jstate,
                                      j_camera(jcfg, view, prev, i))
        color, state, aux = frame(scene, state,
                                  camera_frame(cfg, view, prev, i, "cpu"))
        if i == 0:
            continue
        jg, g = jaux["gbuffer"], aux["gbuffer"]
        pairs = [(getattr(g, k), getattr(jg, k)) for k in (
            "albedo", "normal", "material", "velocity", "depth")]
        pairs += [(aux["ao"], jaux["ao"]), (color, jcolor)]
        for k, (got, want) in enumerate(pairs):
            got = got.numpy()
            assert got.shape == np.shape(want) and np.isfinite(got).all()
            assert psnr(got, np.asarray(want)) >= 40.0, (i, k)
        assert int(aux["overflow"]) == 0 == int(jaux["overflow"])
    assert graphs.log.count("replay") == N_FRAMES
    assert int(state.frame_index) == N_FRAMES == int(jstate.frame_index)
