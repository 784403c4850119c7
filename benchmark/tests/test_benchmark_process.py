"""What a run loads and where it refuses to run: nothing the benchmark
imports is JAX or the JAX package (top-level names compared whole: the
port, vkr_tpu_torch, begins with vkr_tpu); a run without a card, or
outside a checkout of the program, exits non-zero and prints no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import bench_helpers
from harness import result


def test_forbidden_names_are_whole_words():
    assert result.forbidden_modules(["vkr_tpu_torch.frame", "torch",
                                     "vkr_tpu_torchx", "jaxtyping"]) == []
    assert result.forbidden_modules(["vkr_tpu.frame", "jax.numpy",
                                     "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "vkr_tpu"]


def test_the_benchmark_imports_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import run, readings\n"
        "from harness import band, check, program, result, single, spec, "
        "standin, trace, traffic, window, work\n"
        "import ref_world\n"
        "program.render_config(spec.resolve('sponza_orbit').config)\n"
        "from vkr_tpu_torch import frame\n"
        "from vkr_tpu_torch.parallel import band as _b\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "sys.exit(1 if result.forbidden_modules() else 0)\n"
    ) % (os.path.join(bench_helpers.BENCH, "reference"), bench_helpers.BENCH,
         bench_helpers.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "vkr_tpu_torch" in p.stdout and "'jax'" not in p.stdout


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sponza_orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is here")
    p = _run(bench_helpers.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copytree(bench_helpers.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(bench_helpers.ROOT, "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
