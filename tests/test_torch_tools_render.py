"""The port's render tool against vkr_tpu's on the CPU: the oracle frame
(render --no-kernels against vkr_tpu's render --no-pallas) of the
colonnade at 64x64, 2 frames, written as PNG for --show color and
--show ao, and the pass DAG that --dump-dag prints.

vkr_tpu's --no-pallas frame marches with compact_frac=0.25, which drops
rays; the port's march drops none, so the test patches vkr_tpu's march to
compact_frac=0.0 inside the test (vkr_tpu is not edited). vkr_tpu's two
frame compiles are most of this file's time."""

import contextlib
import functools
import io
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke

MIN_PSNR_DB = 40.0
SIZE = 64
RENDER = ["--scene", "colonnade", "--size", str(SIZE), "--frames", "2",
          "--tex-size", "32", "--lut-size", "32"]
# what render prints, in order
LINES = ("backend:", "scene:", "compile+first:", "steady frame:",
         "coverage:", "saved")

torch.set_num_threads(1)


def psnr(a, b, peak=255.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def _dag_names(text):
    return re.findall(r"^\[ *\d+\] (\S+)$", text, flags=re.M)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """{show: (vkr_tpu's PNG, the port's PNG, vkr_tpu's stdout, the
    port's stdout)}, the colour render with --dump-dag."""
    import vkr_tpu.passes.ssr as jssr
    from vkr_tpu.tools import render as j_render
    from vkr_tpu_torch.tools import render

    out = {}
    tmp = tmp_path_factory.mktemp("render")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKR_PLATFORM", "cpu")
        mp.setenv("VKR_DISK_CACHE", str(tmp / "cache"))
        mp.setattr(jssr, "_hierarchical_march", functools.partial(
            jssr._hierarchical_march, compact_frac=0.0))
        for show in ("color", "ao"):
            args = RENDER + ["--show", show] + (
                ["--dump-dag"] if show == "color" else [])
            logs = []
            for side, main, flag in ((0, j_render.main, "--no-pallas"),
                                     (1, render.main, "--no-kernels")):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    main(args + [flag, "--out", str(tmp / f"{show}-{side}"
                                                    ".png")])
                logs.append(buf.getvalue())
            out[show] = (np.asarray(Image.open(tmp / f"{show}-0.png")),
                         np.asarray(Image.open(tmp / f"{show}-1.png")),
                         *logs)
    return out


@pytest.mark.parametrize("show", ["color", "ao"])
def test_render_oracle_frame_against_vkr_tpu(renders, show):
    """render --no-kernels writes the PNG of vkr_tpu's render --no-pallas
    within the repo's 40 dB bar (the AO at half resolution), and prints
    vkr_tpu's lines with vkr_tpu's coverage."""
    jpng, png, jlog, log = renders[show]
    size = SIZE if show == "color" else SIZE // 2
    assert png.shape == jpng.shape == (size, size, 3)
    db = psnr(jpng, png)
    print(f"{show}: {db:.2f} dB")
    assert db >= MIN_PSNR_DB
    for text in (jlog, log):
        starts = [key for ln in text.splitlines() for key in LINES
                  if ln.startswith(key)]
        assert starts == list(LINES), starts
    assert re.search(r"^scene: 10028 triangles", log, flags=re.M)
    cov = [re.search(r"^coverage: (\S+)", t, flags=re.M).group(1)
           for t in (jlog, log)]
    assert cov[0] == cov[1]


def test_render_dump_dag_is_vkr_tpus_chain(renders):
    """--dump-dag prints frame 0's pass DAG: vkr_tpu's task chain."""
    _, _, jlog, log = renders["color"]
    names = _dag_names(log)
    assert names == _dag_names(jlog)
    assert names == chip_smoke.MAIN_CHAIN
