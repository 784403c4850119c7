"""The band frame and the sharded views captured by core/aot.py:cached_jit,
on the CPU.

On the card a CapturedFrame records fn into CUDA graphs; under gloo every
gather of the band frame is a host step (core/aot.py:host_step), where the
capture ends one graph (a segment) and begins the next. The CPU has no
graph, so these tests replace the CUDA side with SegmentGraphs: the fake
graphs of tests/test_torch_traced_frame.py (FakeGraphs) extended to
segments and host steps, whose replay reruns the recorded body on a
thread that stops at each host step, as a segment ends there, while the
step runs on the caller's thread between the segments. The capture itself
runs with every host read refused, as a CUDA graph refuses them.

Ranks are spawned processes in a gloo group on the CPU
(tools/entry.py:run_ranks), one torch thread each, at 64x64 (the
2-column colonnade of tests/test_torch_parallel.py). The captured band
frame and views must equal their eager calls bit for bit, and the band
frame the one-device frame as test_torch_parallel.py holds it; a bin
overflow that one rank drops makes every rank raise BinOverflow at the
same call and capture anew."""

import contextlib
import dataclasses
import queue
import threading
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

GBUF = ("albedo", "normal", "material", "velocity", "depth")
RANKS = 2
FRAMES = 3
OVERFLOW_FRAMES = 4
SESSION_TIMEOUT_S = 300
STEP_TIMEOUT_S = 120
# the default frame's gathers, grouped where they follow each other
# (parallel/band.py): G-buffer planes and overflow; rays and occlusion;
# reflections; blurred SSR; raw, filtered and accumulated AO; colour; TAA
BAND_HOST_STEPS = 9


@contextlib.contextmanager
def refuse_host_reads():
    """Every way a body could read a tensor on the host, or copy a Python
    list to a device, raises (test_torch_traced_frame.no_host_read)."""
    def refuse(name):
        def fail(*a, **kw):
            raise AssertionError(f"host read inside the captured body: "
                                 f"{name}")
        return fail

    targets = [(torch.Tensor, n) for n in (
        "__int__", "__bool__", "__float__", "__index__", "item", "tolist",
        "cpu", "numpy")] + [(torch, "tensor"), (torch, "as_tensor")]
    saved = [(o, n, getattr(o, n)) for o, n in targets]
    try:
        for o, n in targets:
            setattr(o, n, refuse(n))
        yield
    finally:
        for o, n, v in saved:
            setattr(o, n, v)


class FakeEvent:
    """An event whose replay is done once synchronize() has been called,
    or at once (done=True)."""

    def __init__(self, done=True):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class FakeSegments:
    """A captured graph in segments. replay() reruns the recorded body on
    a thread; at host step k the thread writes the tensors it hands the
    step into the ones the capture handed it (as segment k writes them in
    place) and waits; the step then runs here, and the thread goes on with
    the step's static results. Logs "segment k" as segment k ends and
    "step k" after step k; the rerun's results are written into the
    capture's, as a CUDA graph writes its outputs in place."""

    def __init__(self, log, run, out, steps):
        self.log, self.run, self.out, self.steps = log, run, out, steps

    def replay(self):
        from vkr_tpu_torch.core import aot

        to_main, to_body = queue.Queue(), queue.Queue()
        steps = self.steps

        class Resume:
            collective = False
            k = 0

            def step(self, fn, tensors):
                step = steps[self.k]
                for dst, src in zip(step.inputs, tensors):
                    dst.copy_(src)
                to_main.put(("step", self.k))
                self.k += 1
                to_body.get(timeout=STEP_TIMEOUT_S)
                return step.outputs

        def body():
            try:
                with aot._recording(Resume()):
                    to_main.put(("done", self.run()))
            except BaseException as e:  # handed to the caller
                to_main.put(("error", e))

        thread = threading.Thread(target=body, daemon=True)
        thread.start()
        for k in range(len(steps) + 1):
            kind, value = to_main.get(timeout=STEP_TIMEOUT_S)
            if kind == "error":
                raise value
            self.log.append(f"segment {k}")
            if kind == "done":
                break
            steps[k]()
            self.log.append(f"step {k}")
            to_body.put(None)
        assert kind == "done" and k == len(steps), (kind, k)
        thread.join()
        for dst, src in zip(aot._flat(self.out), aot._flat(value)):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)


class SegmentGraphs:
    """aot._CudaGraphs on the CPU with segments: warm-up, capture (every
    host read refused), split at each host step, events, pinned memory,
    each call logged."""

    device_type = "cpu"

    def __init__(self, done=True):
        self.log, self.done, self.released = [], done, 0

    def warm_up(self, run):
        self.log.append("warm_up")
        return run()

    def capture(self, run):
        self.log.append("capture")
        self._steps = []
        with refuse_host_reads():
            out = run()
        return FakeSegments(self.log, run, out, self._steps), out

    def split(self, step):
        self.log.append("split")
        self._steps.append(step)

    def event(self):
        return FakeEvent(self.done)

    def pinned(self, n):
        return torch.zeros(n, dtype=torch.int32)

    def release(self):
        self.released += 1


def replays(host_steps, calls):
    """The log of `calls` replays of a graph with host_steps steps."""
    one = [e for k in range(host_steps)
           for e in (f"segment {k}", f"step {k}")]
    return (one + [f"segment {host_steps}"]) * calls


# ------------------------------------------------- (a) capture and replay


def test_host_steps_alternate_with_segments():
    """A body with two host steps is captured as three segments per graph
    and replayed segment, step, segment, step, segment: each step runs
    after the body's work before it and before the work after it, on the
    tensors that work wrote, and the body after it reads its results.
    Eagerly host_step is fn(*tensors); every call equals the eager fn,
    the state donated."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState

    trace = []

    def double(x):
        trace.append("double")
        return (x * 2.0,)

    def add_sum(x, y):
        trace.append("add_sum")
        return (x + y.sum(), y.sum().reshape(1))

    def fn(x, state):
        trace.append("a")
        (y,) = aot.host_step(double, x + 1.0)
        trace.append("b")
        z, s = aot.host_step(add_sum, y * 3.0, state.prev_depth)
        trace.append("c")
        new = state.replace(prev_depth=state.prev_depth + z.mean(),
                            frame_index=state.frame_index + 1)
        return z - s, new

    xs = [torch.arange(4.0) + i for i in range(4)]
    state, eager = FrameState.initial(2, 2, "cpu"), []
    for x in xs:
        out, state = fn(x, state)
        eager.append((out.clone(), [t.clone() for t in aot._flat(state)]))
    assert trace == ["a", "double", "b", "add_sum", "c"] * 4

    graphs = SegmentGraphs()
    frame = aot.CapturedFrame("steps", fn, donate_argnums=(1,),
                              graphs=graphs)
    state = FrameState.initial(2, 2, "cpu")
    trace.clear()
    for i, x in enumerate(xs):
        out, state = frame(x, state)
        assert torch.equal(out, eager[i][0])
        assert all(torch.equal(a, b) for a, b in zip(aot._flat(state),
                                                     eager[i][1]))
    assert (frame.segments, frame.host_steps) == (3, 2)
    assert graphs.log == (["warm_up", "capture", "split", "split",
                           "capture", "split", "split"] + replays(2, 4))
    # warm-up eager; captures record (no step runs); each replay's steps
    # run between the body's pieces
    assert trace == (["a", "double", "b", "add_sum", "c"]
                     + ["a", "b", "c"] * 2
                     + ["a", "double", "b", "add_sum", "c"] * 4)
    assert frame.step_seconds > 0


def test_frame_without_host_step_is_one_segment():
    """No host step: one segment per graph, no split, one replay each, the
    frames equal to the eager fn (the captured frames of PRs 14-17)."""
    from vkr_tpu_torch.core import aot

    def fn(x):
        return x * 2.0 + 1.0, {"overflow": torch.zeros((), dtype=torch.int32)}

    graphs = SegmentGraphs()
    frame = aot.CapturedFrame("plain", fn, graphs=graphs)
    for i in range(3):
        x = torch.full((3,), float(i))
        assert torch.equal(frame(x)[0], x * 2.0 + 1.0)
    assert (frame.segments, frame.host_steps) == (1, 0)
    assert not frame.collective and frame.step_seconds == 0.0
    assert graphs.log == ["warm_up", "capture", "capture"] + replays(0, 3)


def test_collective_frame_decides_overflow_at_the_next_call():
    """Where fn runs a collective (aot.collective(), which RowGather
    calls), each call waits for the previous call's overflow reading and
    raises on it then; a frame without one reads only replays that have
    completed (an event that has not yet completed is left for later)."""
    from vkr_tpu_torch.core import aot

    def fn(x, with_collective):
        if with_collective:
            aot.collective()
        return x + 1.0, {"overflow": x[0].to(torch.int32)}

    for with_collective in (True, False):
        frame = aot.CapturedFrame(
            "overflow", lambda x: fn(x, with_collective),
            graphs=SegmentGraphs(done=False))
        frame(torch.tensor([5.0, 0.0]))  # replay 1 drops 5 pairs
        if with_collective:
            assert frame.collective
            with pytest.raises(aot.BinOverflow) as err:
                frame(torch.zeros(2))
            assert (err.value.call, err.value.dropped) == (1, 5)
        else:
            assert not frame.collective
            frame(torch.zeros(2))  # the reading of call 1 is pending
            assert len(frame._pending) == 2


def test_row_gather_stats_raise_under_capture():
    """RowGather's stats synchronise the card around each gather: inside a
    CapturedFrame's warm-up or capture they raise, naming step_seconds,
    before any collective runs."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.parallel import band

    with mock.patch.object(band.dist, "get_world_size", return_value=2), \
            mock.patch.object(band.dist, "get_backend", return_value="gloo"):
        gather = band.RowGather(None, "cpu", stats={})
        frame = aot.CapturedFrame("stats", lambda x: (gather(x),),
                                  graphs=SegmentGraphs())
        with pytest.raises(RuntimeError, match="step_seconds"):
            frame(torch.zeros(2, 3))
        with aot._recording(aot._Capture(frame, SegmentGraphs(), [])), \
                pytest.raises(RuntimeError, match="step_seconds"):
            gather(torch.zeros(2, 3))
    assert gather.stats == {}


# ------------------------------------------------------ (b)-(d) on ranks


def _small():
    """tests/test_torch_parallel.py's settings: 64x64, the 2-column
    colonnade (tessellation 6, 32^2 textures), SSR max_iterations 8, LUTs
    of 32, a fixed view, frame i's jitter."""
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.frame import build_ssr_resources, camera_frame
    from vkr_tpu_torch.mathlib.transforms import look_at
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.procedural import colonnade_scene

    cfg = RenderConfig(width=64, height=64)
    cfg = dataclasses.replace(cfg, ssr=dataclasses.replace(
        cfg.ssr, max_iterations=8))
    scene = upload_scene(colonnade_scene(columns=2, tessellation=6,
                                         tex_size=32), "cpu")
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    cams = [camera_frame(cfg, view, view, i, "cpu")
            for i in range(OVERFLOW_FRAMES)]
    return cfg, scene, build_ssr_resources(32, device="cpu"), cams


def _numpy(color, state, aux):
    """The frame's arrays, copied: a captured frame's outputs are its
    graphs' buffers, which the call after next overwrites."""
    f = {k: getattr(aux["gbuffer"], k).numpy().copy() for k in GBUF}
    f.update(color=color.numpy().copy(),
             prev_depth=state.prev_depth.numpy().copy(),
             taa_history=state.taa_history.numpy().copy(),
             overflow=int(aux["overflow"]))
    return f


def _clone(tree):
    from vkr_tpu_torch.core import aot

    return aot._map(tree, lambda t: t.clone() if isinstance(
        t, torch.Tensor) else t)


class _Spy:
    """A CapturedFrame as call_or_recapture sees it, keeping the call
    number of each BinOverflow it raised."""

    def __init__(self, frame):
        self.frame, self.donated, self.raised = frame, frame.donated, []

    def __call__(self, *args):
        from vkr_tpu_torch.core import aot

        try:
            return self.frame(*args)
        except aot.BinOverflow as err:
            self.raised.append((err.call, err.dropped))
            raise

    def cache_clear(self):
        self.frame.cache_clear()


def _band_session(rank, n, device):
    """One rank: the band frame eager and captured (SegmentGraphs) over
    FRAMES frames; the views eager and captured; a capture whose bin-pair
    capacities rank 0 cuts below its counts, through call_or_recapture."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.parallel import (batch_cams, batch_states,
                                        make_render_mesh,
                                        render_frame_banded,
                                        render_views_sharded)
    from vkr_tpu_torch.raster import setup
    from vkr_tpu_torch.tools.entry import same_bits

    cfg, scene, res, cams = _small()

    def fresh():
        return FrameState.initial(cfg.height, cfg.width, device)

    def band(scene_in, state_in, cam_in):
        return render_frame_banded(scene_in, state_in, cam_in, res, cfg,
                                   device=device)

    out = {}
    state, eager = fresh(), []
    for cam in cams[:FRAMES]:
        color, state, aux = band(scene, state, cam)
        eager.append(_clone((color, state, aux)))

    graphs = SegmentGraphs()
    frame = aot.CapturedFrame("band", band, donate_argnums=(1,),
                              graphs=graphs)
    state, equal, frames = fresh(), [], []
    for i, cam in enumerate(cams[:FRAMES]):
        color, state, aux = frame(scene, state, cam)
        equal.append(same_bits((color, state, aux), eager[i]))
        frames.append(_numpy(color, state, aux))
    out.update(band=frames, band_equal=equal, log=graphs.log,
               segments=frame.segments, host_steps=frame.host_steps,
               collective=frame.collective)

    mesh = make_render_mesh(device=device)

    def views(scene_in, states_in, cams_in):
        return render_views_sharded(scene_in, states_in, cams_in, res, cfg,
                                    mesh)

    vcams = batch_cams(cams[:n])
    states, want = batch_states(fresh, n), []
    for _ in range(2):
        colors, states = views(scene, states, vcams)
        want.append(_clone((colors, states)))
    vgraphs = SegmentGraphs()
    vframe = aot.CapturedFrame("views", views, donate_argnums=(1,),
                               graphs=vgraphs)
    states, vequal = batch_states(fresh, n), []
    for i in range(2):
        colors, states = vframe(scene, states, vcams)
        vequal.append(same_bits((colors, states), want[i]))
    out.update(views_equal=vequal, views_segments=vframe.segments,
               views_log=vgraphs.log)

    # rank 0's first capture takes its counts less one pair: its capture
    # frame drops pairs, the others' do not
    real, cut = setup.static_capacities, [rank == 0]

    def capacities(counts):
        if cut and cut.pop():
            return [max(c - 1, 1) for c in counts]
        return real(counts)

    spy = _Spy(aot.CapturedFrame("band_overflow", band, donate_argnums=(1,),
                                 graphs=SegmentGraphs()))
    state, sums, after = fresh(), [], []
    with mock.patch.object(setup, "static_capacities", capacities):
        for i, cam in enumerate(cams):
            carried = _clone(state)
            color, state, aux = aot.call_or_recapture(spy, scene, state, cam)
            sums.append(int(aux["overflow"]))
            if spy.raised:
                after.append(same_bits((color, state, aux),
                                       band(scene, carried, cam)))
    out.update(raised=spy.raised, overflow_sums=sums, after_equal=after,
               captures=spy.frame.captures)
    return out


def _one_device():
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.frame import render_frame

    cfg, scene, res, cams = _small()
    state, frames = FrameState.initial(64, 64, "cpu"), []
    for cam in cams[:FRAMES]:
        color, state, aux = render_frame(scene, state, cam, res, cfg)
        frames.append(_numpy(color, state, aux))
    return frames


@pytest.fixture(scope="module")
def ranks():
    from vkr_tpu_torch.tools.entry import run_ranks

    return run_ranks(_band_session, RANKS, "cpu", SESSION_TIMEOUT_S)


def test_captured_band_frame_equals_eager(ranks):
    """On 2 ranks, 3 frames of the band frame captured in segments equal
    the eager band frame bit for bit (colour, every FrameState field, the
    G-buffer, hi-Z, SSR, AO and rays, overflow), and so the one-device
    frame as tests/test_torch_parallel.py holds it: G-buffer and
    prev_depth bit for bit, colour and TAA history within 1e-6, overflow
    0. Each graph has 9 host steps and 10 segments; every replay runs
    them in turn."""
    single = _one_device()
    for out in ranks:
        assert out["band_equal"] == [True] * FRAMES
        assert (out["segments"], out["host_steps"]) == (
            BAND_HOST_STEPS + 1, BAND_HOST_STEPS)
        assert out["collective"]
        assert out["log"] == (
            (["warm_up"] + (["capture"] + ["split"] * BAND_HOST_STEPS) * 2)
            + replays(BAND_HOST_STEPS, FRAMES))
        for i, (b, s) in enumerate(zip(out["band"], single)):
            for k in GBUF + ("prev_depth",):
                np.testing.assert_array_equal(b[k], s[k],
                                              err_msg=f"frame {i} {k}")
            assert b["overflow"] == s["overflow"] == 0
            for k in ("color", "taa_history"):
                np.testing.assert_allclose(b[k], s[k], rtol=0, atol=1e-6,
                                           err_msg=f"frame {i} {k}")


def test_captured_views_equal_eager(ranks):
    """render_views_sharded captured with the batched state donated: two
    segments (one host step, its gather), two calls bit-equal to the
    eager calls on every rank."""
    for out in ranks:
        assert out["views_equal"] == [True, True]
        assert out["views_segments"] == 2
        assert out["views_log"] == (
            ["warm_up", "capture", "split", "capture", "split"]
            + replays(1, 2))


def test_overflow_on_one_rank_recaptures_every_rank(ranks):
    """Rank 0's capture frame drops bin pairs, rank 1's does not; the
    summed overflow is the same on both, so both raise BinOverflow for
    replay 1 at the next call, capture anew there (call_or_recapture) and
    go on without a hang; the frames after the recapture equal the eager
    band frame on the state carried over, bit for bit, with overflow 0."""
    sums = [out["overflow_sums"] for out in ranks]
    assert sums[0] == sums[1] and sums[0][0] > 0
    assert sums[0][1:] == [0] * (OVERFLOW_FRAMES - 1)
    for out in ranks:
        assert [call for call, _ in out["raised"]] == [1]
        assert out["raised"][0][1] == sums[0][0]
        assert out["captures"] == 2
        assert out["after_equal"] == [True] * (OVERFLOW_FRAMES - 1)
