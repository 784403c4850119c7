"""A run driven on the CPU at a tiny size (the harness's look for a card
skipped), sound and with the timed path broken underneath: `correct`
comes out true for the sound runs and false for each fault the cells can
have: a frame that returns its state unchanged, an answer altered where
it is produced (the final colour; the SSR pass's reflections, which the
independent chain's SSR number catches), the exchange between the band
frame's ranks left out.

The control (the reference with TF32 products in the program's place)
needs the card: its test is marked `card`."""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest
import torch

import bench_helpers
from harness import spec


def run_tiny(tmp_path, workload, seed=5, hook=None, seconds=1.0,
             bench=None):
    """(exit code, the result line) of a tiny run of workload on the
    CPU; bench: a BENCHMARK.json of the test's own."""
    import run

    root = bench_helpers.tiny_root(str(tmp_path), bench=bench)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      device="cpu", root=root, hook=hook)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def state_unchanged():
    """The frame returns the state it was given."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.parallel import band

    def keep_state(real):
        def broken(scene, state, *args, **kw):
            colour, _, aux = real(scene, state, *args, **kw)
            return colour, state, aux
        return broken
    frame.render_frame = keep_state(frame.render_frame)
    band.render_frame_banded = keep_state(band.render_frame_banded)


def colour_altered():
    """The final colour of the top eighth of the rows 5% off where the
    frame produces it."""
    from vkr_tpu_torch import frame

    real = frame.render_frame

    def broken(*args, **kw):
        colour, state, aux = real(*args, **kw)
        colour = colour.clone()
        colour[:colour.shape[0] // 8] *= 1.05
        return colour, state, aux
    frame.render_frame = broken


def ssr_altered():
    """The blurred reflections 5% off where the SSR pass produces them."""
    from vkr_tpu_torch.passes import ssr

    real = ssr.ssr_blur

    def broken(*args, **kw):
        return real(*args, **kw) * 1.05
    ssr.ssr_blur = broken


def no_exchange():
    """Each band rank gathers only its own band: the other rows stay
    zero."""
    from vkr_tpu_torch.parallel import band

    def local(self, n_bands, *xs):
        import torch.distributed as dist

        r = dist.get_rank(self.group)
        out = []
        for i, x in enumerate(xs):
            if i < n_bands:
                whole = torch.zeros((self.n * x.shape[0],) + tuple(
                    x.shape[1:]), dtype=x.dtype, device=x.device)
                whole[r * x.shape[0]:(r + 1) * x.shape[0]] = x
            else:
                whole = x.clone()
            out.append(whole)
        return tuple(out)
    band.RowGather._collect = local


@pytest.fixture
def restore():
    """Put back what a fault patched in this process."""
    from vkr_tpu_torch import frame
    from vkr_tpu_torch.parallel import band

    from vkr_tpu_torch.passes import ssr

    saved = (frame.render_frame, band.render_frame_banded,
             band.RowGather._collect, ssr.ssr_blur)
    yield
    (frame.render_frame, band.render_frame_banded,
     band.RowGather._collect, ssr.ssr_blur) = saved


@pytest.mark.parametrize("workload", ["sponza_orbit", "rt_orbit"])
def test_sound_run_is_correct(tmp_path, workload):
    rc, line = run_tiny(tmp_path, workload)
    assert rc == 0 and line["correct"] is True
    assert list(line)[-1] == "checks" and line["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault,group", [(state_unchanged, "state"),
                                         (colour_altered, "colour"),
                                         (colour_altered, "ind_colour"),
                                         (ssr_altered, "ind_ssr")])
def test_a_broken_frame_is_not_correct(tmp_path, restore, fault, group):
    rc, line = run_tiny(tmp_path, "rt_orbit", hook=fault)
    assert rc == 0 and line["correct"] is False
    assert line["checks"][group]["value"] > line["checks"][group]["limit"]


def band_bench():
    """BENCHMARK.json with the band frame's cell added, as a later
    benchmark change would add it: a configuration entry and a cell."""
    bench = spec.load_benchmark(bench_helpers.ROOT)
    name = "colonnade_band4_1440p"
    with open(os.path.join(bench_helpers.BENCH, "configs",
                           f"{name}.json")) as f:
        conf = json.load(f)
    bench["configs"].append({k: conf[k] for k in ("name", "source",
                                                   "reduced", "why")}
                            | {"file": f"benchmark/configs/{name}.json"})
    bench["workloads"].append({"name": "band4_orbit", "config": name,
                               "traffic": "orbit_loop", "chips": 4,
                               "why": "the band frame"})
    return bench


def test_sound_band_run_is_correct(tmp_path):
    rc, line = run_tiny(tmp_path, "band4_orbit", bench=band_bench())
    assert rc == 0 and line["correct"] is True


@pytest.mark.parametrize("fault", [no_exchange, state_unchanged])
def test_a_broken_band_frame_is_not_correct(tmp_path, fault):
    rc, line = run_tiny(tmp_path, "band4_orbit", hook=fault,
                        bench=band_bench())
    assert rc == 0 and line["correct"] is False


@pytest.mark.card
def test_the_control_is_not_correct(tmp_path, card):
    """The reference with TF32 products in the program's place, at a
    small size on the card, fails the comparison (the cells' readings on
    the chip are in PERF.md)."""
    from harness import check, single, spec

    root = bench_helpers.tiny_root(str(tmp_path), 480, 272)
    cell = spec.resolve("sponza_orbit", root)
    out = single.run_cell(cell, 9, 1.0, False, card, 0.0, control=True)
    assert not check.verdict(out["readings"])


@pytest.mark.card
def test_sound_run_on_the_card_is_correct(tmp_path, card):
    from harness import check, single, spec

    root = bench_helpers.tiny_root(str(tmp_path), 480, 272)
    cell = spec.resolve("rt_orbit", root)
    out = single.run_cell(cell, 9, 1.0, False, card, 0.0)
    assert check.verdict(out["readings"]), out["readings"]
