"""The harness's arithmetic on synthetic inputs: the window's statistics,
the trace reduction (busy, idle, gaps), the gather bytes and roofline,
the traffic's sweep, the choice of checked frames, the comparison."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

import bench_helpers  # noqa: F401
from harness import check, spec, trace, window, work
from harness.peaks import PEAK_BYTES_PER_S
from harness.traffic import Traffic

ORBIT = bench_helpers.os.path.join(bench_helpers.BENCH, "traffic",
                                   "orbit_loop.json")


def steady(n, ms, start=0.0):
    return [start + (i + 1) * ms / 1e3 for i in range(n)]


def test_frame_ms_and_p95_of_a_steady_window():
    c = steady(300, 60.0)
    assert window.frame_ms(0.0, c) == pytest.approx(60.0)
    assert window.frame_p95_ms(0.0, c) == pytest.approx(60.0)


def test_one_stall_moves_both():
    c = steady(300, 60.0)
    stalled = c[:150] + [t + 0.5 for t in c[150:]]   # one 500 ms stall
    assert window.frame_ms(0.0, stalled) > window.frame_ms(0.0, c) + 1.5
    # the stall is one interval of 299: the 95th percentile holds; 20
    # stalls (more than 5% of the intervals) move it
    many = list(c)
    for k in range(20, 300, 14):
        many = many[:k] + [t + 0.05 for t in many[k:]]
    assert window.frame_p95_ms(0.0, many) > 100.0
    assert window.frame_p95_ms(0.0, stalled) >= 60.0
    assert max(window.intervals_ms(0.0, stalled)) == pytest.approx(560.0)
    # a window of one frame has one interval, from its start
    assert window.frame_p95_ms(0.0, [0.07]) == pytest.approx(70.0)


def test_window_run_counts_frames_and_failures():
    seen = []

    def dispatch(k):
        seen.append(k)
        return k == 7
    w = window.run(dispatch, None, 2, 5, window.Events(False),
                   keep_going=lambda k, _: k < 15)
    assert seen == list(range(5, 15)) and w.frames == 10 and w.failed == 1
    assert all(b >= a for a, b in zip(w.completions, w.completions[1:]))


def test_busy_idle_and_gaps():
    dev = [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "a"),
           (9.0, 12.0, "c")]
    assert trace.busy_seconds(dev, 0.0, 10.0) == pytest.approx(4.0)
    gaps = trace.gaps(dev, 0.0, 10.0)
    assert gaps[0] == (4.0, 9.0) and gaps[1] == (2.0, 3.0)
    host = [(4.0, 9.5, "cudaEventSynchronize"), (0.0, 10.0, "outer")]
    assert trace.idle_gaps(dev, host, 0.0, 10.0, top=1) == [
        ("cudaEventSynchronize", 5.0)]
    assert trace.host_label([], 1.0) == "host idle"
    assert trace.count_in(dev, 0.0, 3.0) == 3
    assert dict(trace.top_ops(dev, 0.0, 10.0))["a"] == pytest.approx(2.0)


def test_gather_bytes_and_roofline():
    # K5 on a (540, 960) image at full rows: image + 2 offset planes + out
    b = work.gather_bytes("window_gather_bilinear", [(540, 960)],
                          [(540, 960), (540, 960)])
    assert b == 4 * 540 * 960 * 4
    # a band call reads only its rows and the halo
    band = work.gather_bytes("window_gather_bilinear", [(540, 960)],
                             [(135, 960), (135, 960)], radius=16)
    assert band == int(540 * 960 * 4 * (135 + 33) / 540) + 3 * 135 * 960 * 4
    k4 = work.gather_bytes("window_gather_bilinear_multi", [(540, 960)],
                           [(16, 540, 960), (16, 540, 960)])
    assert k4 == 4 * 540 * 960 * (1 + 3 * 16)
    k6 = work.gather_bytes("taa_history_gather", [(1080, 1920, 3),
                                                  (1080, 1920)],
                           [(1080, 1920), (1080, 1920)])
    assert k6 == 4 * 1080 * 1920 * (3 + 1 + 2 + 16)
    read = spec.load_reader("gather_roofline", bench_helpers.ROOT)
    ctx = types.SimpleNamespace(
        gather_bytes_per_frame=PEAK_BYTES_PER_S * 1e-3,
        ranks=[{"gather_s": 4e-3, "frames": 2}])
    assert read(ctx) == pytest.approx(50.0)
    ctx.ranks = [{"gather_s": 0.0, "frames": 2}]
    assert read(ctx) is None


def test_idle_and_kernel_readers_take_the_worst_rank():
    ranks = [{"busy_s": 0.9, "window_s": 1.0, "device_ops": 100,
              "frames": 10, "nccl_s": 0.0},
             {"busy_s": 0.5, "window_s": 1.0, "device_ops": 300,
              "frames": 10, "nccl_s": 0.02}]
    ctx = types.SimpleNamespace(ranks=ranks)
    root = bench_helpers.ROOT
    assert spec.load_reader("device_idle_share", root)(ctx) == \
        pytest.approx(50.0)
    assert spec.load_reader("kernels_per_frame", root)(ctx) == 30.0
    assert spec.load_reader("nccl_ms_per_frame", root)(ctx) == \
        pytest.approx(2.0)
    ctx.ranks = []
    assert spec.load_reader("device_idle_share", root)(ctx) is None


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_orbit_loop_stays_in_the_hall(seed):
    t = Traffic.load(ORBIT)
    angles = [t.angle(seed, k) for k in range(3 * t.period)]
    assert min(angles) >= 0.0 and max(angles) <= 0.15 + 1e-12
    # every seed shows the same angles, as often, over a period
    one = sorted(round(a, 9) for a in angles[:t.period])
    ref = sorted(round(t.angle(0, k), 9) for k in range(t.period))
    assert one == ref
    assert np.isfinite(t.view(seed, 5)).all()


def test_checked_pairs_are_drawn_from_the_seed():
    a = check.draw_pairs(5, 2, 6, 160)
    assert a == check.draw_pairs(5, 2, 6, 160) and len(set(a)) == 2
    assert all(6 <= i < 160 for i in a) and abs(a[1] - a[0]) >= 2
    assert check.draw_pairs(2 ** 31 + 11, 2, 6, 160) != a or True


def test_compare_and_verdict():
    x = torch.rand(4, 5, 3)
    outs = {"colour": x, "ssr": x[..., :2], "ao": x[..., 0],
            "overflow": torch.tensor(0), "gbuffer.depth": x[..., 1],
            "state.taa_history": x}
    chain = {"ind_ssr": {"ssr": x[..., :2]}, "ind_ao": {"ao": x[..., 0]},
             "ind_colour": {"colour": x, "state.taa_history": x}}
    frozen = check.compare(outs, outs)
    # a frame the independent chain did not judge is not correct
    assert not check.verdict(frozen)
    same = check.worst([frozen, check.compare_groups(outs, chain)])
    assert check.verdict(same) and same["colour"] == 0.0
    assert same["ind_colour"] == 0.0
    bad = dict(outs, colour=x + 0.5)
    r = check.worst([check.compare(bad, outs),
                     check.compare_groups(bad, chain)])
    assert r["colour"] > 0.1 and r["ind_colour"] > 0.1
    assert not check.verdict(r)
    nan = dict(outs, ao=x[..., 0] * math.nan)
    assert not check.verdict(check.worst([same, check.compare(nan, outs)]))
    assert not check.verdict(check.compare(
        dict(outs, overflow=torch.tensor(3)), outs))
