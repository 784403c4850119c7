"""The warm-start entry, under vkr_tpu's name: cached_jit.

vkr_tpu serialises the traced frame (jax.export) so that a later process
skips Python tracing (vkr_tpu/core/aot.py). Eager PyTorch has no trace to
keep. What a port process pays for at start-up, and keeps on disk for the
next, is building the hand-written CUDA kernels (kernels.build(): nvcc
into build/, keyed by each source's hash), the native asset pipeline
(native.build()) and the SSR LUTs (frame.build_ssr_resources, in the disk
cache). cached_jit builds and loads the first two up front when its
example arguments live on the card, so the first frame launches no
compiler, and returns the function itself: the frame it runs is exactly
fn's. On CPU tensors there is nothing to build; the kernels' plain
versions are the CPU's path.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

from vkr_tpu_torch.core.graph import _leaves


def cached_jit(name: str, fn: Callable, example_args, *, donate_argnums=(),
               cache_dir: str | None = None, verbose: bool = False,
               extra_key: str = "") -> Callable:
    """fn, with what its first call on the card would build built first.

    vkr_tpu's signature (vkr_tpu/core/aot.py:104). When example_args hold
    a CUDA tensor, the CUDA kernel libraries and the native asset
    pipeline are built (if their hashed files are missing) and loaded;
    with verbose, the seconds go to stderr under `name`. VKR_AOT=0 skips
    this, as it skips vkr_tpu's export. donate_argnums, cache_dir and
    extra_key key or place vkr_tpu's serialised trace; the port has none,
    and its builds are keyed by their sources (kernels.library_path,
    native.library_path), so they are accepted and not used."""
    del donate_argnums, cache_dir, extra_key
    if os.environ.get("VKR_AOT", "1") != "1" or not any(
            getattr(leaf, "is_cuda", False)
            for leaf in _leaves(example_args)):
        return fn
    from vkr_tpu_torch import kernels, native

    t0 = time.perf_counter()
    kernels.build()
    for lib in kernels.SOURCES:
        kernels.library(lib)
    t1 = time.perf_counter()
    native.load()
    if verbose:
        print(f"aot: {name}: CUDA kernels ({', '.join(kernels.SOURCES)}) "
              f"built and loaded in {t1 - t0:.2f} s, native asset pipeline "
              f"in {time.perf_counter() - t1:.2f} s", file=sys.stderr,
              flush=True)
    return fn
