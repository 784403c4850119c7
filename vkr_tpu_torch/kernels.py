"""Build and load the port's hand-written CUDA kernels.

Each csrc/<name>.cu is compiled with nvcc into its own shared library with
a plain C interface (build/lib<name>-<hash>.so, the hash covering source
and flags), loaded with ctypes. Building happens at first use, or up front
with build(); all missing libraries compile in parallel, one nvcc process
each. Nothing here runs at import.

Flags: sm_90a (Hopper), -O3, and -fmad=false: without it nvcc fuses
a*b + c into an FMA that skips the product's rounding, and the kernels
would no longer equal their plain PyTorch versions bit for bit (eager
PyTorch rounds every product). No --use_fast_math: the passes' 1e-20
guards rely on IEEE float32.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("gbuf_tiles", "window_gather", "ssr_march", "ray_any_hit",
           "ssr_blur")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    "gbuf_tiles": {
        "vkr_gbuf_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _P],
        "vkr_rasterize_tiles": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                                _P, _P],
    },
    "window_gather": {
        "vkr_window_gather": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _P, _P],
        "vkr_window_gather_empty": [_I, _I, _P],
        "vkr_window_gather_multi": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _P,
                                    _P],
        "vkr_taa_history_gather": [_P, _P, _I, _I, _I, _I, _P, _P, _F, _P,
                                   _P],
    },
    "ssr_march": {
        "vkr_ssr_march": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I,
                          _F, _F, _F, _F, _F, _I, _P, _P, _P, _P, _P],
    },
    "ray_any_hit": {
        "vkr_ray_any_hit": [_P, _P, _F, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                            _I, _I, _P, _P],
    },
    "ssr_blur": {
        "vkr_ssr_blur": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    },
}

_loaded: dict = {}

# Kernel launches per wrapper name. Each wrapper adds one where it launches
# its CUDA kernel and nowhere else (a CPU tensor's plain version does not
# count); a run that must show its path went through the kernels clears
# this before and reads it after.
LAUNCHES: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                             digest_size=8).hexdigest()
    return BUILD / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every library of `names` not built yet, all in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
