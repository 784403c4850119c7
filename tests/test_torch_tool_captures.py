"""The tools' captured frames on the CPU, with fakes in place of the CUDA
graphs: a replay that dropped bin pairs (core/aot.py:BinOverflow) makes
render, showcase and the viewer capture anew at the current view, the
frame state carried over, where vkr_tpu's tools render on; the viewer
keeps at most MAX_CAPTURES captures and drops the one used least
recently."""

import pytest
import torch

from test_torch_traced_frame import FakeGraphs
from vkr_tpu_torch.tools.entry import same_bits

SMALL = ["--tex-size", "32", "--lut-size", "32"]

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("VKR_PLATFORM", "cpu")
    monkeypatch.setenv("VKR_DISK_CACHE", str(tmp_path / "cache"))


def _state_tensors(state):
    from vkr_tpu_torch.core.aot import _flat

    return [t for t in _flat(state) if isinstance(t, torch.Tensor)]


class FakeCaptured:
    """A captured frame as the tools see it (core/aot.py:CapturedFrame's
    call, donated, cache_clear): it runs fn, and its call number
    `raise_at` raises BinOverflow once, before running, as a replay's
    overflow is raised at the next call. Keeps each call's state argument
    and colour (clones), and what each call returned as state."""

    def __init__(self, fn, raise_at=None):
        self.fn, self.raise_at = fn, raise_at
        self.donated = (1,)
        self.attempts = self.cleared = 0
        self.states_in, self.states_out, self.colors = [], [], []

    def __call__(self, *args):
        from vkr_tpu_torch.core.aot import BinOverflow

        self.attempts += 1
        if self.attempts == self.raise_at:
            raise BinOverflow(f"call {self.attempts - 1} dropped 7 bin pairs",
                              self.attempts - 1, 7)
        self.states_in.append(args[1])
        color, state, aux = self.fn(*args)
        self.states_out.append(state)
        self.colors.append(color.clone())
        return color, state, aux

    def cache_clear(self):
        self.cleared += 1


def _fake_jit(monkeypatch, raise_at):
    """Patch cached_jit: each call makes a FakeCaptured (kept in the
    returned list)."""
    from vkr_tpu_torch.core import aot

    made = []

    def fake(name, fn, example_args, **kw):
        assert kw.get("donate_argnums") == (1,)
        made.append(FakeCaptured(fn, raise_at))
        return made[-1]

    monkeypatch.setattr(aot, "cached_jit", fake)
    return made


def test_call_or_recapture_on_a_captured_frame():
    """A CapturedFrame whose replay dropped pairs raises BinOverflow at the
    next call (call and count); call_or_recapture then drops the graphs,
    captures anew on that call's arguments with a copy of the state the
    last replay returned, and replays: the result is fn on that state.
    Dropping the graphs hands their pools back (graphs.release())."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.core.framestate import FrameState

    def fn(x, state):
        new = state.replace(prev_depth=state.prev_depth + x.sum(),
                            frame_index=state.frame_index + 1)
        return x * 2.0, new, {"overflow": x[0].to(torch.int32)}

    graphs = FakeGraphs()
    frame = aot.CapturedFrame("overflow", fn, donate_argnums=(1,),
                              graphs=graphs)
    state = FrameState.initial(4, 4, "cpu")
    _, state, _ = aot.call_or_recapture(frame, torch.zeros(3), state)
    _, state, aux = aot.call_or_recapture(frame, torch.tensor([5.0, 1, 1]),
                                          state)
    assert int(aux["overflow"]) == 5 and frame.captures == 1
    returned = [t.clone() for t in _state_tensors(state)]
    # called directly, the frame raises; the reading is then consumed
    spare = aot.CapturedFrame("spare", fn, donate_argnums=(1,),
                              graphs=FakeGraphs())
    s0 = FrameState.initial(4, 4, "cpu")
    _, s0, _ = spare(torch.tensor([3.0, 0, 0]), s0)
    with pytest.raises(aot.BinOverflow) as err:
        spare(torch.zeros(3), s0)
    assert (err.value.call, err.value.dropped) == (1, 3)
    assert isinstance(err.value, RuntimeError)
    graphs.log.clear()
    x = torch.tensor([0.0, 1.0, 1.0])
    y, new, _ = aot.call_or_recapture(frame, x, state)
    assert graphs.log == ["warm_up", "capture", "capture", "replay"]
    assert frame.captures == 2 and frame.calls == 3
    assert graphs.released == 1  # the dropped graphs' pools went back
    assert y.tolist() == [0.0, 2.0, 2.0]
    want = fn(x, FrameState(*returned))[1]
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(new),
                                                 _state_tensors(want)))
    _, again, _ = aot.call_or_recapture(frame, torch.zeros(3), new)
    assert int(again.frame_index) == 4 and frame.captures == 2


def _tool_run(tool, monkeypatch, tmp_path, raise_at):
    from vkr_tpu_torch.tools import render, showcase, viewer

    made = _fake_jit(monkeypatch, raise_at)
    if tool == "render":
        render.main(["--scene", "colonnade", "--width", "48", "--height",
                     "32", "--frames", "5", *SMALL, "--out",
                     str(tmp_path / f"r{raise_at}.png")])
    elif tool == "showcase":
        for name, value in (("COLUMNS", 4), ("TESSELLATION", 8),
                            ("TEX_SIZE", 32), ("LUT_SIZE", 32),
                            ("SKIP", 2)):
            monkeypatch.setattr(showcase, name, value)
        showcase.main(["--out-dir", str(tmp_path / f"s{raise_at}"),
                       "--frames", "5", "--width", "48", "--height", "32"])
    else:
        port = _free_port()
        viewer.main(["--max-frames", "5", "--port", str(port), "--width",
                     "48", "--height", "32", "--columns", "2", *SMALL])
    assert len(made) == 1
    return made[0]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("tool", ["render", "showcase", "viewer"])
def test_tool_recaptures_after_an_overflow(tool, monkeypatch, tmp_path):
    """The tool's third frame finds a replay's overflow: it drops the
    capture (cache_clear, once), captures anew at that frame's view and
    goes on to its last frame. The state the retry passes is a copy of the
    state the second frame returned (equal, not the same tensors), and
    every frame equals the frame of a run without the overflow."""
    clean = _tool_run(tool, monkeypatch, tmp_path, None)
    fake = _tool_run(tool, monkeypatch, tmp_path, 3)
    assert fake.attempts == 6 and len(fake.colors) == 5 == len(clean.colors)
    assert fake.cleared == 1 and clean.cleared == 0
    before, retry = fake.states_out[1], fake.states_in[2]
    for a, b in zip(_state_tensors(before), _state_tensors(retry)):
        assert torch.equal(a, b) and a is not b
    for a, b in zip(fake.colors, clean.colors):
        assert torch.equal(a, b)


def test_viewer_keeps_at_most_max_captures(monkeypatch):
    """The viewer's captures live in an LRU of MAX_CAPTURES (2 here): over
    the toggle keys K0, K1, K0, K2, K3, K2 it makes K0, K1, K2, K3 once
    each, drops K1 (then the least recently used) when K2 comes and K0 when
    K3 comes, with their cache_clear(); never more than 2 are live."""
    from vkr_tpu_torch import frame as F
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.tools import viewer

    monkeypatch.setattr(viewer, "MAX_CAPTURES", 2)
    made, live = [], []

    class Frame:
        def __init__(self, name):
            self.name, self.cleared = name, 0
            self.donated = (1,)

        def __call__(self, scene, state, cam, tun):
            return torch.zeros(32, 48, 3), state, {}

        def cache_clear(self):
            self.cleared += 1

    def fake(name, fn, example_args, **kw):
        made.append(Frame(name))
        live.append(sum(f.cleared == 0 for f in made))
        return made[-1]

    monkeypatch.setattr(aot, "cached_jit", fake)
    states = []

    class Spy(viewer.ViewerState):
        def __init__(self):
            super().__init__()
            states.append(self)

    # the toggles frame i + 1 sees, set while frame i makes its camera
    flips = ["ssr", "ssr", "gtao", "ssr", "ssr"]
    camera_frame = F.camera_frame

    def flipping(cfg, view, prev, i, dev, use_jitter=True):
        if i < len(flips):
            with states[0].lock:
                states[0].toggles[flips[i]] ^= True
        return camera_frame(cfg, view, prev, i, dev, use_jitter=use_jitter)

    monkeypatch.setattr(viewer, "ViewerState", Spy)
    monkeypatch.setattr(F, "camera_frame", flipping)
    viewer.main(["--max-frames", "6", "--port", str(_free_port()),
                 "--width", "48", "--height", "32", "--columns", "2",
                 *SMALL])
    keys = [f.name for f in made]
    assert len(keys) == 4 == len(set(keys))
    assert [f.cleared for f in made] == [1, 1, 0, 0]
    assert max(live) == 2
    tg = viewer.ViewerState().toggles
    k0 = tuple(tg[k] for k in viewer.CONFIG_TOGGLES)
    assert keys[0] == f"viewer {k0}"


PROFILE_SMALL = ["--width", "32", "--height", "32", "--reps", "2",
                 "--tex-size", "16", "--lut-size", "16", "--columns", "2",
                 "--tessellation", "4"]


def test_profile_captures_each_pass(monkeypatch, capsys):
    """profile with cached_jit making a CapturedFrame over FakeGraphs: the
    ten passes are captured by name, in PASSES order, none donated, each
    warmed up, captured twice and replayed at its first call and at each
    of --reps; main returns the ten names and prints each as its line's
    first word. Each pass's output through its capture equals fn's on
    the same inputs bit for bit (profile.run_passes, the chain main
    times)."""
    from vkr_tpu_torch.core import aot
    from vkr_tpu_torch.tools import profile

    made = []

    def fake(name, fn, example_args, **kw):
        graphs = FakeGraphs()
        made.append((name, kw.get("donate_argnums", ()), graphs))
        return aot.CapturedFrame(name, fn, donate_argnums=kw.get(
            "donate_argnums", ()), graphs=graphs)

    monkeypatch.setattr(aot, "cached_jit", fake)
    times = profile.main(PROFILE_SMALL)
    lines = capsys.readouterr().out.splitlines()[1:]
    assert tuple(times) == profile.PASSES == tuple(n for n, _, _ in made)
    assert [ln.split()[0] for ln in lines] == list(profile.PASSES)
    assert all("(capture " in ln for ln in lines)
    assert all(donated == () for _, donated, _ in made)
    for _, _, graphs in made:
        assert graphs.log == ["warm_up", "capture", "capture"] + [
            "replay"] * 3

    def held(name, fn, args):
        want = [t.clone() for t in aot._flat(fn(*args))
                if isinstance(t, torch.Tensor)]
        out = aot.CapturedFrame(name, fn, graphs=FakeGraphs())(*args)
        got = [t for t in aot._flat(out) if isinstance(t, torch.Tensor)]
        assert len(got) == len(want) > 0, name
        for a, b in zip(got, want):
            assert same_bits(a, b), name
        return out

    profile.run_passes(profile.parse_args(PROFILE_SMALL),
                       torch.device("cpu"), held)
