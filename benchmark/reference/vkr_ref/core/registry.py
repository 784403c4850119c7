"""Pass registry + hot reload — the analog of the reference's shader
manifest and shader hot reload, as vkr_tpu/core/registry.py has it.

The reference declares its 36 shader programs by name in
src/shaders/config.json, loads them at start-up (main.cpp:178-215) and
rebuilds every pipeline when `R` is pressed (gpu::reload_shaders,
main.cpp:319-321). Here a program is a pass entry point. The registry
stores (module, qualname), not the function object, so `get()` resolves
against the live module: after `importlib.reload(<edited pass module>)`,
or a `setattr` that swaps a function on its module (a plain version in
place of a kernel wrapper, a timer around a pass), the next frame calls
the new code. The frame (frame.py) builds every pass through `get()`.

Hot reload = `reload()`: re-import the registered pass modules, then drop
what the port keeps across frames (`clear_caches`): the captured frames'
CUDA graphs (core/aot.py, tracked with `track_jit`), the small tables it
caches with functools (tracked with `track_cache`) and the loaded CUDA
libraries (kernels._loaded). Emptying the latter makes the next launch
load the library of the source as it is now, which kernels.library_path
names by the source's hash, so an edited csrc/*.cu is rebuilt there; a
dropped graph is captured anew at its next call, from the code as it is
now.
"""

from __future__ import annotations

import importlib
import sys
import weakref
from typing import Callable, Dict, List, Optional, Tuple

# program name -> (module name, qualified attribute name)
_REGISTRY: Dict[str, Tuple[str, str]] = {}
# functools-cached callables that reload() must empty
_TRACKED_CACHES: List[Callable] = []
# frame-level callables whose captures reload() must drop, held weakly: a
# frame its caller dropped takes its graphs and their memory with it
_TRACKED_JITS: "weakref.WeakSet[Callable]" = weakref.WeakSet()


def register(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a pass entry point under a program name of the
    reference's config.json (e.g. 'gtao_main', 'sssr_trace',
    'taa_resolve', 'defered_shading'), as vkr_tpu names it."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = (fn.__module__, fn.__qualname__)
        return fn

    return deco


def get(name: str) -> Callable:
    """Resolve a program name against the live module (so a reloaded or
    patched module's current definition wins)."""
    mod_name, qualname = _REGISTRY[name]
    mod = sys.modules.get(mod_name)
    if mod is None:
        mod = importlib.import_module(mod_name)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def names() -> List[str]:
    return sorted(_REGISTRY)


def track_cache(cached: Callable) -> Callable:
    """Track a functools-cached callable so reload()/clear_caches() empty
    it (the pipeline-rebuild half of the reference's reload_shaders,
    pipelines.cpp:49-60)."""
    _TRACKED_CACHES.append(cached)
    return cached


def clear_caches() -> None:
    """Empty every tracked cache and every registered function's own
    functools cache, and unload the CUDA libraries (they load again, from
    the current sources, at their next launch)."""
    from vkr_ref import kernels

    for fn in [*_TRACKED_CACHES, *_TRACKED_JITS]:
        clear = getattr(fn, "cache_clear", None)
        if clear is not None:
            clear()
    for name in _REGISTRY:
        clear = getattr(get(name), "cache_clear", None)
        if clear is not None:
            clear()
    kernels._loaded.clear()


def track_jit(fn: Callable) -> Callable:
    """Track a frame-level callable so reload()/clear_jit_caches() drop
    what it keeps: vkr_tpu tracks its frame jits to drop their traces; the
    port's counterpart is a captured frame (core/aot.py:CapturedFrame,
    which cached_jit tracks itself), whose cache_clear() drops its CUDA
    graphs, so the next call captures anew. A callable with a functools
    cache is emptied; a plain callable (a frame built on registry.get)
    needs nothing: it resolves each pass anew at every call. Held by a
    weak reference."""
    _TRACKED_JITS.add(fn)
    return fn


def clear_jit_caches() -> None:
    """vkr_tpu's name for clear_caches()."""
    clear_caches()


def reload(only_module: Optional[str] = None) -> List[str]:
    """Hot reload (reference: key R -> gpu::reload_shaders): re-import the
    registered pass modules (or just `only_module`) and clear the caches,
    so edited pass code and kernel sources take effect without restarting
    the process. Returns the module names reloaded."""
    mods = sorted({m for (m, _) in _REGISTRY.values()}
                  if only_module is None else {only_module})
    for m in mods:
        if m in sys.modules:
            importlib.reload(sys.modules[m])
    clear_caches()
    return mods
